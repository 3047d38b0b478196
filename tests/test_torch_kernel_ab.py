"""kernel_ab.py derives its variants of the backward kernels 2 and 6 from
the sources by string patches; each patch must find its anchor exactly
once in this tree's sources, or the script raises on the card."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import kernel_ab  # noqa: E402


def test_kernel_ab_patches_this_trees_kernels():
    variants = kernel_ab.tree_variants()
    assert set(variants) == {"k6_sync_staging", "k6_no_cull", "k6_no_half_rows",
                             "k6_maxrregcount_64", "k6_cull_counters", "k2_sync_staging",
                             "k2_no_half_rows", "k2_with_cull", "k2_maxrregcount_64"}
    for name, (text, flags) in variants.items():
        assert "tdgs_rasterize_" in text, name
        assert ("abl_counts" in text) == name.endswith("_counters"), name
        assert flags == (["-maxrregcount=64"] if "maxrreg" in name else []), name
