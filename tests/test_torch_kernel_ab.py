"""kernel_ab.py derives its variants of the kernels 10 and 9 from the
sources by string patches; each patch must find its anchor exactly once in
this tree's sources, or the script raises on the card."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import kernel_ab  # noqa: E402


def test_kernel_ab_patches_this_trees_kernels():
    variants = kernel_ab.tree_variants()
    assert set(variants) == {"k10_as_is", "k9_as_is", "k10_sync_staging",
                             "k10_scalar_zeros_after_walk", "k10_wide_zeros_after_walk",
                             "k10_no_cull",
                             "k9_sync_staging", "k9_no_cull", "k9_eigenvalue_cull",
                             "k9_warp_skip", "k9_cull_counters"}
    for name, text in variants.items():
        assert "tdgs_rasterize_" in text, name
        assert ("abl_counts" in text) == name.endswith("_counters"), name
        # the synchronous builds inline row_stage.cuh, its copies patched
        assert ('#include "row_stage.cuh"' in text) != name.endswith("_sync_staging"), name
