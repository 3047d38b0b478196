"""The port's public surface against the JAX package's.

- ``set(tdgs.__all__) <= set(tdgs_torch.__all__)``, every name resolving.
- Every public top-level function and class of ``tdgs/`` (an ``ast`` walk
  over both trees) has a counterpart of that name at the top level of some
  module of ``tdgs_torch/``, but for the modules left out by design and the
  names whose work a port function of another name does (both listed in
  ROADMAP; the named counterparts must exist).
- The reference's drop-in kwargs: ``packed``, ``sparse_grad``,
  ``segmented``, ``channel_chunk`` and a single-process ``distributed``
  render bitwise what the plain call renders; ``absgrad`` without the tap
  raises naming it; ``distributed`` refuses batched gaussians and eval3d.
- ``SelectiveAdam`` equals the functional ``selective_adam`` step for step
  (bitwise) and the JAX class within 1e-6 relative; ``se3_apply`` the JAX
  one within 1e-6.
"""

import ast
import importlib
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tdgs
import tdgs_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# modules of tdgs/ left out of the port by design (ROADMAP, "Unported by design")
BY_DESIGN = {
    "utils.platform",  # pins JAX's platform
    "utils.reference_oracle",  # needs an upstream checkout the repository lacks
    "datasets._native",  # the C++ decoder; the port decodes through utils/png.py and PIL
}
# JAX names whose work a port function of another name does
NAMED = {
    "quat_multiply": "tdgs_torch.ops.transforms:quat_mul",
    "add_blur": "tdgs_torch.ops.projection:fully_fused_projection",
    "persp_proj": "tdgs_torch.ops.projection:proj",
    "init_camera_opt": "tdgs_torch.training.modules:CameraOptModule",
    "init_appearance_opt": "tdgs_torch.training.modules:AppearanceOptModule",
    "apply_appearance_opt": "tdgs_torch.training.modules:AppearanceOptModule",
    "sorted_segment_rows_sum": "tdgs_torch.ops.segment_sum:segment_rows_sum",
}


def _top_level(root, kinds):
    """{name: [module, ...]} of the top-level names of ``kinds`` bound in the
    package under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(os.path.join(REPO, root)):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            mod = os.path.relpath(path, os.path.join(REPO, root))[:-3].replace(os.sep, ".")
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in tree.body:
                names = []
                if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                    names = [node.name]
                elif isinstance(node, ast.Assign) and ast.Assign in kinds:
                    names = [t.id for t in node.targets if isinstance(t, ast.Name)]
                for name in names:
                    if not name.startswith("_"):
                        out.setdefault(name, []).append(mod)
    return out


def test_all_names_exported():
    assert set(tdgs.__all__) <= set(tdgs_torch.__all__)
    for name in tdgs_torch.__all__:
        assert getattr(tdgs_torch, name) is not None, name


def test_every_public_function_and_class_has_a_counterpart():
    jax_names = _top_level("tdgs", (ast.FunctionDef, ast.ClassDef))
    port_names = _top_level("tdgs_torch", (ast.FunctionDef, ast.ClassDef, ast.Assign))
    missing = {n: mods for n, mods in jax_names.items()
               if n not in port_names and n not in NAMED
               and not all(m in BY_DESIGN for m in mods)}
    assert not missing, missing
    for target in NAMED.values():
        mod, attr = target.split(":")
        assert hasattr(importlib.import_module(mod), attr), target


def _scene(seed=2, N=48):
    rng = np.random.default_rng(seed)
    return dict(
        means=(rng.normal(size=(N, 3)) + [0, 0, 5]).astype(np.float32),
        quats=rng.normal(size=(N, 4)).astype(np.float32),
        scales=rng.uniform(0.05, 0.3, size=(N, 3)).astype(np.float32),
        opacities=rng.uniform(0.3, 1, size=(N,)).astype(np.float32),
        colors=(rng.normal(size=(N, 16, 3)) * 0.3).astype(np.float32),
        viewmats=np.eye(4, dtype=np.float32)[None],
        Ks=np.array([[[60.0, 0, 32], [0, 60, 24], [0, 0, 1]]], np.float32),
    )


@pytest.mark.parametrize("rasterizer", ["packed_inference", "jax"])
def test_dropin_kwargs_render_identically(rasterizer):
    sc = _scene()
    common = dict(sh_degree=3, device="cpu", rasterizer=rasterizer, tile_capacity=256)
    want = tdgs_torch.rasterization(*sc.values(), 64, 48, **common)
    got = tdgs_torch.rasterization(*sc.values(), 64, 48, packed=True, sparse_grad=True,
                                   segmented=True, channel_chunk=8, distributed=True,
                                   **common)
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g, w)
    want2 = tdgs_torch.rasterization_2dgs(*sc.values(), 64, 48, **common)
    got2 = tdgs_torch.rasterization_2dgs(*sc.values(), 64, 48, eps2d=0.1, packed=False,
                                         sparse_grad=True, **common)
    for g, w in zip(got2[:2], want2[:2]):
        assert torch.equal(g, w)


def test_absgrad_needs_the_tap():
    sc = _scene()
    for fn in (tdgs_torch.rasterization, tdgs_torch.rasterization_2dgs):
        with pytest.raises(ValueError, match="means2d_abs_tap"):
            fn(*sc.values(), 64, 48, absgrad=True, rasterizer="packed", device="cpu")
    tap = torch.zeros((1, 48, 2), requires_grad=True)
    img, _, _ = tdgs_torch.rasterization(*sc.values(), 64, 48, absgrad=True,
                                         means2d_abs_tap=tap, rasterizer="packed",
                                         sh_degree=3, device="cpu")
    (g,) = torch.autograd.grad(img.square().sum(), tap)
    assert (g >= 0).all() and g.sum() > 0


def test_distributed_refuses_batched_and_eval3d():
    from tdgs_torch.rendering import _rasterization_distributed

    sc = _scene()
    args = list(sc.values())
    batched = [a[None] for a in args]
    kw = dict(rasterizer="packed_inference", with_eval3d=False, with_ut=False,
              backgrounds=None)
    with pytest.raises(ValueError, match="unbatched"):
        _rasterization_distributed(*batched, 64, 48, "cpu", **kw)
    with pytest.raises(ValueError, match="eval3d"):
        _rasterization_distributed(*args, 64, 48, "cpu", **dict(kw, with_eval3d=True))


def _adam_case(seed=0, n=64):
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(size=(n, 3)).astype(np.float32),
              "b": rng.normal(size=(n,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(4)]
    vis = [rng.uniform(size=n) > 0.3 for _ in range(4)]
    return params, grads, vis


@pytest.mark.parametrize("lr", [1e-2, {"a": 1e-2, "b": 3e-3}])
def test_selective_adam_class(lr):
    from tdgs.ops.adam import SelectiveAdam as JAdam
    from tdgs_torch.ops.adam import SelectiveAdam, selective_adam

    params, grads, vis = _adam_case()
    opt = SelectiveAdam({k: torch.as_tensor(v) for k, v in params.items()}, lr=lr)
    jopt = JAdam({k: jnp.asarray(v) for k, v in params.items()}, lr=lr)
    # the functional transformation, one group at a time (its lr is a scalar)
    fn_params = {k: torch.as_tensor(v) for k, v in params.items()}
    init, update = {}, {}
    for key in params:
        init[key], update[key] = selective_adam(lr[key] if isinstance(lr, dict) else lr)
    states = {k: init[k]({k: fn_params[k]}) for k in params}
    for g, v in zip(grads, vis):
        got = opt.step({k: torch.as_tensor(x) for k, x in g.items()},
                       visibility=torch.as_tensor(v))
        want = jopt.step({k: jnp.asarray(x) for k, x in g.items()}, visibility=jnp.asarray(v))
        for k in params:
            steps, states[k] = update[k]({k: torch.as_tensor(g[k])}, states[k],
                                         visibility=torch.as_tensor(v))
            fn_params[k] = fn_params[k] + steps[k]
            assert torch.equal(got[k], fn_params[k]), k
            w = np.asarray(want[k])
            assert np.abs(got[k].numpy() - w).max() <= 1e-6 * np.abs(w).max(), k
    # masked rows kept their value
    frozen = ~np.any(np.stack(vis), axis=0)
    assert np.array_equal(opt.params["b"].numpy()[frozen], params["b"][frozen])


def test_se3_apply_matches_jax():
    from tdgs.ops.transforms import se3_apply as j_se3
    from tdgs_torch.ops.transforms import se3_apply

    rng = np.random.default_rng(4)
    R = rng.normal(size=(2, 3, 3)).astype(np.float32)
    t = rng.normal(size=(2, 3)).astype(np.float32)
    p = rng.normal(size=(2, 10, 3)).astype(np.float32)
    want = np.asarray(j_se3(jnp.asarray(R), jnp.asarray(t), jnp.asarray(p)))
    got = se3_apply(torch.as_tensor(R), torch.as_tensor(t), torch.as_tensor(p)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
