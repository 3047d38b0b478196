"""kernel_ab.py derives its variants of the kernels 7 and 1 from the sources
by string patches; each patch must find its anchor exactly once in this
tree's sources, or the script raises on the card."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import kernel_ab  # noqa: E402


def test_kernel_ab_patches_this_trees_kernels():
    variants = kernel_ab.tree_variants()
    assert set(variants) == {"k7_as_is", "k1_as_is", "k7_no_cull", "k7_sphere_cull",
                             "k7_frame_in_registers", "k7_sync_staging", "k7_4_byte_copies",
                             "k7_uncapped_registers", "k7_cull_counters", "k1_no_cull",
                             "k1_sync_staging", "k1_cull_counters", "k1_timeline"}
    for name, text in variants.items():
        assert "tdgs_rasterize_" in text, name
        assert ("abl_counts" in text) == name.endswith("_counters"), name
        assert ("abl_spans" in text) == name.endswith("_timeline"), name
        # the synchronous builds inline row_stage.cuh, its copies patched
        # into plain loads and stores
        synchronous = name.endswith("_sync_staging")
        assert ("= *src(f);" in text) == synchronous, name
        if name.startswith("k7_"):
            assert ('#include "row_stage.cuh"' in text) != synchronous, name
            # the cull is the header's but in the variants that replace it
            assert ("tdgsraycull::may_reach(" in text) != (name in ("k7_no_cull",
                                                                    "k7_sphere_cull")), name
        else:
            # kernel 1's variants of the shared walk inline composite_walk.cuh
            inlined = name in ("k1_no_cull", "k1_sync_staging", "k1_cull_counters")
            assert ('#include "composite_walk.cuh"' in text) != inlined, name
            if inlined:
                assert ("tdgscull::may_reach(" in text) != (name == "k1_no_cull"), name
