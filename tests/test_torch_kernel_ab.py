"""kernel_ab.py derives its variants of the kernels 4 and 5 from the sources
by string patches; each patch must find its anchor exactly once in this
tree's sources, or the script raises on the card."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import kernel_ab  # noqa: E402


def test_kernel_ab_patches_this_trees_kernels():
    variants = kernel_ab.tree_variants()
    assert set(variants) == {"as_is", "no_cull", "sync_staging", "k4_gathered_rows",
                             "capped_48", "cull_counters"}
    assert variants["as_is"] == {}
    for name, overrides in variants.items():
        text = "".join(overrides.values())
        assert ("abl_counts" in text) == name.endswith("_counters"), name
        # the synchronous build patches row_stage.cuh's copies into plain
        # loads and stores
        assert ("= *src(f);" in text) == (name == "sync_staging"), name
        if "surfel_walk.cuh" in overrides:
            walk = overrides["surfel_walk.cuh"]
            assert ("may_reach(g, pix.x0" in walk) != (name == "no_cull"), name
        if "rasterize_2dgs_fwd.cu" in overrides:
            fwd = overrides["rasterize_2dgs_fwd.cu"]
            assert "tdgs_rasterize_2dgs_fwd_train" in fwd, name
            assert ("flatten_ids[start + from + lane]" in fwd) != (name == "k4_gathered_rows")
            assert ("__maxnreg__(48)" in fwd) == (name == "capped_48"), name
