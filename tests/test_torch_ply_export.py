"""The port's splat file writers and readers (``tdgs_torch/utils/ply.py``)
against the JAX package's (``tdgs/utils/ply.py``), on splats from a seed.

Writers (``save_ply``, ``save_splat``, ``save_ply_compressed`` and
``export_splats`` in each format, with extra properties): files byte for
byte equal. Readers (``load_ply``, ``load_ply_milo``,
``load_ply_compressed``): arrays equal, on the JAX package's files.
"""

import numpy as np
import pytest
import torch

from tdgs.utils import ply as J
from tdgs_torch.utils import ply as T


def _splats(n=700, k=15, seed=11):
    rng = np.random.default_rng(seed)
    return {
        "means": (rng.normal(size=(n, 3)) * 2).astype(np.float32),
        "scales": rng.normal(-3, 0.5, size=(n, 3)).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "opacities": rng.normal(0, 3, size=(n,)).astype(np.float32),
        "sh0": rng.normal(size=(n, 1, 3)).astype(np.float32),
        "shN": (rng.normal(size=(n, k, 3)) * 0.3).astype(np.float32),
    }


ORDER = ("means", "scales", "quats", "opacities", "sh0", "shN")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fmt", ["ply", "splat", "ply_compressed"])
@pytest.mark.parametrize("k", [15, 0])
def test_export_splats_bytes_equal(tmp_path, fmt, k):
    s = _splats(k=k)
    extra = {"identity_encodings": np.random.default_rng(2).normal(size=(700, 16))
             .astype(np.float32)} if fmt == "ply" else None
    J.export_splats(*(s[x] for x in ORDER), format=fmt, save_to=str(tmp_path / "j"),
                    extra=extra)
    # the port also takes tensors
    T.export_splats(*(torch.as_tensor(s[x]) for x in ORDER), format=fmt,
                    save_to=str(tmp_path / "t"), extra=extra)
    want = _bytes(tmp_path / "j")
    assert len(want) > 0 and _bytes(tmp_path / "t") == want


def test_writers_bytes_equal(tmp_path):
    s = _splats(n=1000)
    J.save_splat(str(tmp_path / "j.splat"), *(s[x] for x in ORDER[:5]))
    T.save_splat(str(tmp_path / "t.splat"), *(s[x] for x in ORDER[:5]))
    assert _bytes(tmp_path / "t.splat") == _bytes(tmp_path / "j.splat")
    for chunk in (256, 100):
        J.save_ply_compressed(str(tmp_path / "j.ply"), *(s[x] for x in ORDER), chunk_size=chunk)
        T.save_ply_compressed(str(tmp_path / "t.ply"), *(s[x] for x in ORDER), chunk_size=chunk)
        assert _bytes(tmp_path / "t.ply") == _bytes(tmp_path / "j.ply")
    with pytest.raises(ValueError, match="opacity threshold"):
        T.save_ply_compressed(str(tmp_path / "x.ply"), s["means"], s["scales"], s["quats"],
                              np.full(1000, -20.0, np.float32), s["sh0"], s["shN"])
    with pytest.raises(ValueError, match="unsupported format"):
        T.export_splats(*(s[x] for x in ORDER), format="glb", save_to=str(tmp_path / "y"))


def test_readers_arrays_equal(tmp_path):
    s = _splats()
    J.save_ply(str(tmp_path / "a.ply"), *(s[x] for x in ORDER),
               extra={"identity_encodings": np.ones((700, 4), np.float32)})
    J.save_ply_compressed(str(tmp_path / "c.ply"), *(s[x] for x in ORDER))
    for name, jfn, tfn in (("a.ply", J.load_ply, T.load_ply),
                           ("a.ply", J.load_ply_milo, T.load_ply_milo),
                           ("c.ply", J.load_ply_compressed, T.load_ply_compressed)):
        want, got = jfn(str(tmp_path / name)), tfn(str(tmp_path / name))
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, (name, key)
            assert np.array_equal(got[key], want[key]), (name, key)
    # the milo reader keeps the channel-interleaved column order
    milo = T.load_ply_milo(str(tmp_path / "a.ply"))["shN"]
    flat = s["shN"].transpose(0, 2, 1).reshape(700, -1)
    assert np.array_equal(milo, flat.reshape(700, 15, 3))
