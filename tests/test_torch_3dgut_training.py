"""Port parity of 3DGUT training against the JAX package: the MCMC
relocation (``compute_relocation``), the MCMC refine and position noise
fed the JAX package's own draws (``jax.random.categorical`` and
``jax.random.normal`` with the same key), the configuration carried across
both ways, one 3DGUT ``Runner`` step with an MCMC refine from the same
state (the JAX package on the CPU takes its jnp ``"eval3d"`` path, the
port its ``"eval3d_packed"`` rasterizer's plain versions), and the command
line's ``mcmc`` preset.

Tolerances: relocation and the MCMC operations 1e-5 relative (the same
float32 arithmetic); the Runner step's loss 1e-3 relative and its
parameters as tests/test_torch_training.py holds the 3DGS step, with the
Adam moments to 2e-2 of the largest (the two eval3d rasterizers tile and
order entries differently and differ by about 1e-3 at this scale).
"""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tdgs.strategy.mcmc as jmcmc
from tdgs.ops.relocation import compute_relocation as j_reloc, make_binoms as j_binoms
from tdgs.strategy import MCMCStrategy as JMCMC
from tdgs.strategy.ops import (
    inject_noise_to_position as j_noise,
    refine_mcmc as j_refine,
)
from tdgs_torch import convert
from tdgs_torch.ops.relocation import compute_relocation, make_binoms
from tdgs_torch.strategy import MCMCStrategy
from tdgs_torch.strategy import mcmc as tmcmc
from tdgs_torch.strategy.ops import (
    inject_noise_to_position,
    mcmc_sample_sources,
    refine_mcmc,
)
from tests.test_torch_training import _close_rel

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tier runs six test processes on the machine's cores: two
    intra-op threads each keep PyTorch from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(tree):
    return convert.tree_from_numpy(tree, device="cpu")


def test_compute_relocation_matches_jax():
    rng = np.random.default_rng(1)
    n = 200
    op = rng.uniform(0.01, 0.99, size=n).astype(np.float32)
    scales = np.exp(rng.uniform(-4, -1, size=(n, 3))).astype(np.float32)
    ratios = rng.integers(1, 60, size=n).astype(np.int32)  # past n_max = 51 too
    ratios[:3] = [1, 51, 80]
    want = j_reloc(jnp.asarray(op), jnp.asarray(scales), jnp.asarray(ratios), j_binoms())
    binoms = make_binoms(device="cpu")
    np.testing.assert_array_equal(binoms.numpy(), np.asarray(j_binoms()))
    got = compute_relocation(*map(torch.from_numpy, (op, scales, ratios)), binoms)
    for g, w in zip(got, want):
        _close_rel(g.numpy(), np.asarray(w), RTOL)


def _mcmc_state(seed, C=400, n_alive=300):
    """Splats at capacity C, the first n_alive active, a third of them dead
    (opacity below 0.005), and random Adam moments."""
    rng = np.random.default_rng(seed)
    op = rng.uniform(0.02, 0.9, size=C)
    op[rng.uniform(size=C) < 0.33] = 0.002
    op[n_alive:] = 0.0009
    splats = {
        "means": rng.normal(size=(C, 3)),
        "quats": rng.normal(size=(C, 4)),
        "scales": rng.uniform(-4.0, -1.5, size=(C, 3)),
        "opacities": np.log(op / (1 - op)),
        "sh0": rng.normal(size=(C, 1, 3)),
        "shN": rng.normal(size=(C, 3, 3)) * 0.1,
    }
    splats = {k: v.astype(np.float32) for k, v in splats.items()}
    opt = {part: {k: rng.normal(size=v.shape).astype(np.float32) ** 2 for k, v in splats.items()}
           for part in ("mu", "nu")}
    return splats, opt


def _jax_sources(splats, key, n_before, min_opacity=0.005):
    """The categorical draw of the JAX package's refine_mcmc, with its key."""
    op = jax.nn.sigmoid(jnp.asarray(splats["opacities"]))
    slots = jnp.arange(op.shape[0])
    alive = (slots < n_before) & (op > min_opacity)
    eps = jnp.finfo(jnp.float32).eps
    logits = jnp.log(jnp.maximum(jnp.where(alive, op, 0.0), eps)) + jnp.where(alive, 0.0, -1e9)
    return np.array(jax.random.categorical(key, logits, shape=(op.shape[0],)))


def test_refine_mcmc_matches_jax_given_its_draws():
    splats, opt = _mcmc_state(2)
    key = jax.random.PRNGKey(5)
    n_before, n_target = 300, 315
    want_p, want_o, want_n = j_refine(
        {k: jnp.asarray(v) for k, v in splats.items()},
        {p: {k: jnp.asarray(v) for k, v in d.items()} for p, d in opt.items()},
        key, jnp.int32(n_before), jnp.int32(n_target), j_binoms(), 0.005)
    sampled = torch.from_numpy(_jax_sources(splats, key, n_before))
    got_p, got_o, got_n = refine_mcmc(_t(splats), _t(opt), sampled, n_before, n_target,
                                      make_binoms(device="cpu"), 0.005)
    assert int(got_n) == int(want_n) > 0
    for k in splats:
        _close_rel(got_p[k].numpy(), np.asarray(want_p[k]), RTOL, k)
        for part in ("mu", "nu"):
            np.testing.assert_array_equal(got_o[part][k].numpy(), np.asarray(want_o[part][k]))
    # the relocated and the new rows took live sources
    op = torch.sigmoid(got_p["opacities"])
    assert bool((op[:n_target] > 0.005).all())


def test_mcmc_draws_follow_opacity():
    """The port's draw takes live rows of the active region only, each with
    probability ∝ its opacity (4096 draws against the expected counts)."""
    splats, _ = _mcmc_state(3, C=64, n_alive=40)
    params = _t(splats)
    g = torch.Generator().manual_seed(0)
    draws = torch.cat([mcmc_sample_sources(params, g, 40) for _ in range(64)])
    op = torch.sigmoid(params["opacities"])
    alive = (torch.arange(64) < 40) & (op > 0.005)
    assert bool(alive[draws].all())
    counts = torch.bincount(draws, minlength=64).double()
    expect = len(draws) * torch.where(alive, op, 0.0).double() / float(op[alive].sum())
    chi2 = float(((counts - expect)[alive] ** 2 / expect[alive]).sum())
    assert chi2 < 3.0 * int(alive.sum())
    dead = {k: v.clone() for k, v in params.items()}
    dead["opacities"][:] = -7.0
    assert mcmc_sample_sources(dead, g, 40) is None


def test_inject_noise_matches_jax_given_its_draws():
    splats, _ = _mcmc_state(4)
    key = jax.random.PRNGKey(6)
    active = np.arange(400) < 300
    want = j_noise({k: jnp.asarray(v) for k, v in splats.items()}, key, jnp.float32(0.7),
                   active_mask=jnp.asarray(active))
    noise = torch.from_numpy(np.array(jax.random.normal(key, splats["means"].shape)))
    got = inject_noise_to_position(_t(splats), noise, 0.7, torch.from_numpy(active))
    moved = np.abs(np.asarray(want["means"]) - splats["means"]).max(-1) > 0
    assert moved[:300].any() and not moved[300:].any()
    _close_rel(got["means"].numpy(), np.asarray(want["means"]), RTOL)


def test_config_goes_both_ways():
    from tdgs.training.config import Config as JConfig
    from tdgs_torch.training.config import Config as TConfig

    j_fields = {f.name for f in dataclasses.fields(JConfig)}
    assert j_fields == {f.name for f in dataclasses.fields(TConfig)}
    jcfg = JConfig(with_ut=True, with_eval3d=True, init_opa=0.5, opacity_reg=0.01,
                   strategy=JMCMC(cap_max=1234, refine_every=50))
    tcfg = convert.config_from_dict(convert.config_to_dict(jcfg))
    assert isinstance(tcfg.strategy, MCMCStrategy)
    assert tcfg.strategy.cap_max == 1234 and tcfg.strategy.refine_every == 50
    assert tcfg.with_ut and tcfg.with_eval3d and tcfg.init_opa == 0.5
    back = convert.config_to_dict(tcfg)
    strat = dict(back.pop("strategy"))
    assert strat.pop("type") == "MCMCStrategy"
    again = JConfig(strategy=JMCMC(**strat), **back)
    assert again == jcfg


# ---------------------------------------------------------------------------
# one 3DGUT Runner step of each package from the same state, with a refine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tdgs_torch.utils.test_data import make_colmap_test_scene

    root = str(tmp_path_factory.mktemp("scene"))
    make_colmap_test_scene(root, device="cpu")
    return root


def _configs(scene, tmp):
    from tdgs.training.config import Config as JConfig
    from tdgs_torch.training.config import Config as TConfig

    kw = dict(data_dir=scene, data_factor=1, max_steps=1, eval_steps=[], save_steps=[],
              sh_degree=1, sh_degree_interval=1, tile_capacity=256, isect_capacity=1 << 14,
              test_every=4, tb_every=1, with_ut=True, with_eval3d=True, init_opa=0.5,
              init_scale=0.1, opacity_reg=0.01, scale_reg=0.01, seed=3)
    sk = dict(cap_max=512, refine_start_iter=0, refine_every=1)
    return (JConfig(result_dir=str(tmp / "j"), strategy=JMCMC(**sk), data_prefetch=False,
                    **kw),
            TConfig(result_dir=str(tmp / "t"), strategy=MCMCStrategy(**sk), **kw))


def test_one_3dgut_mcmc_runner_step_matches_jax(scene, tmp_path, monkeypatch):
    """Step 1 renders through the UT projection and the eval3d rasterizer,
    takes the loss with the MCMC regularizers, Adam, then refines (the dead
    rows relocated, 5% growth) and adds the position noise. The port is
    handed the JAX package's draws, recorded where its jitted refine and
    noise are called."""
    from tdgs.training.trainer import Runner as JRunner
    from tdgs_torch.training.trainer import Runner as TRunner

    jcfg, tcfg = _configs(scene, tmp_path)
    jr = JRunner(jcfg)
    rng = np.random.default_rng(11)
    splats = {k: np.array(v) for k, v in jr.splats.items()}
    n_init = jr.strategy_state["n_alive"]
    # a mid-training state: some of the initial gaussians have died
    dead = np.nonzero(rng.uniform(size=n_init) < 0.2)[0]
    splats["opacities"][dead] = -6.0
    splats["shN"][:n_init] = rng.normal(size=splats["shN"][:n_init].shape) * 0.1
    opt = {part: {k: (rng.uniform(0, 1e-4, size=v.shape) if part == "nu"
                      else rng.normal(size=v.shape) * 1e-3).astype(np.float32)
                  for k, v in splats.items()} for part in ("mu", "nu")}
    jr.splats = jax.tree.map(jnp.asarray, splats)
    jr.opt_state = jax.tree.map(jnp.asarray, opt)
    strat = {"binoms": np.asarray(jr.strategy_state["binoms"]), "n_alive": n_init}
    state0 = {"step": 0, "splats": splats, "opt_state": opt, "strategy_state": strat}

    drawn = {}
    refine, noise = jmcmc._refine_jit, jmcmc._noise_jit

    def record_refine(params, opt_state, key, n_before, n_target, binoms, min_opacity):
        drawn["sources"] = _jax_sources({"opacities": np.asarray(params["opacities"])}, key,
                                        int(n_before), min_opacity)
        return refine(params, opt_state, key, n_before, n_target, binoms, min_opacity)

    def record_noise(params, key, scaler, n_alive):
        drawn["noise"] = np.array(jax.random.normal(key, params["means"].shape))
        return noise(params, key, scaler, n_alive)

    monkeypatch.setattr(jmcmc, "_refine_jit", record_refine)
    monkeypatch.setattr(jmcmc, "_noise_jit", record_noise)
    j_hist = jr.train()["history"]

    monkeypatch.setattr(tmcmc, "mcmc_sample_sources",
                        lambda *a: torch.from_numpy(drawn["sources"]))
    monkeypatch.setattr(tmcmc, "position_noise", lambda *a: torch.from_numpy(drawn["noise"]))
    tr = TRunner(tcfg, device="cpu")
    assert tr.capacity == 512 and tr.strategy_state["n_alive"] == n_init
    tr.load_state_numpy(convert.runner_state_from_numpy(state0, device="cpu"))
    t_hist = tr.train()["history"]
    np.testing.assert_allclose(t_hist[0]["loss"], j_hist[0]["loss"], rtol=1e-3)
    assert tr.strategy_state["n_alive"] == jr.strategy_state["n_alive"] == int(1.05 * n_init)
    assert tr.refines[0]["n_relocated"] == len(dead)

    after = convert.runner_state_to_numpy({"step": 1, "splats": tr.splats,
                                           "opt_state": tr.opt_state,
                                           "strategy_state": tr.strategy_state})
    lr = tr.optimizer.lr_at(1)
    moved = np.zeros(512, bool)
    moved[:int(1.05 * n_init)] = True
    for k in splats:
        for part in ("mu", "nu"):
            got, want = after["opt_state"][part][k], np.asarray(jr.opt_state[part][k])
            assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max(), (part, k)
        got, want = after["splats"][k], np.asarray(jr.splats[k])
        step = np.abs(want - splats[k]).max()
        # one Adam step of size at most about the learning rate, plus the
        # position noise for the means: the two agree to a small part of it
        tol = 6.4 * lr[k] + (1e-3 * step if k == "means" else 0.0)
        assert np.abs(got - want).max() <= tol, k
    np.testing.assert_array_equal(after["strategy_state"]["binoms"],
                                  np.asarray(jr.strategy_state["binoms"]))


def test_mcmc_preset_cli(scene, tmp_path, capsys):
    """The mcmc preset's overrides and strategy; a short MCMC run (3DGS
    rasterizer) with a refine; with_ut without with_eval3d refuses to
    train."""
    from tdgs_torch.simple_trainer import build_parser, config_from_args, main

    cfg = config_from_args(build_parser().parse_args(
        ["mcmc", "--cap-max", "300", "--with-ut", "--with-eval3d", "--init-opa", "0.4"]))
    assert isinstance(cfg.strategy, MCMCStrategy) and cfg.strategy.cap_max == 300
    assert (cfg.init_opa, cfg.init_scale, cfg.opacity_reg, cfg.scale_reg) == (0.4, 0.1, 0.01, 0.01)
    assert cfg.with_ut and cfg.with_eval3d
    common = ["--data-dir", scene, "--data-factor", "1", "--eval-steps", "800",
              "--save-steps", "", "--tile-capacity", "256", "--sh-degree", "1",
              "--test-every", "4", "--tb-every", "4", "--disable-video", "--device", "cpu",
              "--cap-max", "300", "--max-steps", "800", "--steps-scaler", "0.01"]
    # 8 steps; the refines (every 100 · 0.01 steps after 500 · 0.01) at 6, 7, 8
    assert main(["mcmc", "--result-dir", str(tmp_path / "o"), *common]) == 0
    out = capsys.readouterr().out
    assert out.count("relocated") == 3
    assert json.loads(out.strip().splitlines()[-1])["num_GS"] > 120
    with pytest.raises(ValueError, match="with_eval3d"):
        main(["mcmc", "--with-ut", "--result-dir", str(tmp_path / "p"), *common])
