"""What decides ``correct``, driven through the train cell's driver at a
size a CPU holds, on the system's CPU path: a sound run is correct; the
control (the reference in bfloat16 in the system's place) is not; nor is a
run with the timed path broken underneath, once for each fault the cell
can have (a step that returns its state unchanged, half of the batch left
out, the relocation's sources drawn against MCMC's law). There is no
exchange between cards to leave out: the cell runs on one."""

import json
import os
from types import SimpleNamespace

import pytest

from portbench import control, run

HERE = run.HERE


def _load(*parts):
    return json.load(open(os.path.join(HERE, *parts)))


def tiny(width=64, height=48, n_gauss=3000):
    cfg = _load("configs", "bicycle_mcmc1m.json")
    cfg["scene"].update(n_gt=3000, sfm_points=300, n_images=8, width=width, height=height)
    cfg["state"]["n_gauss"] = n_gauss
    cfg["trainer"]["cap_max"] = n_gauss
    traffic = dict(_load("traffic", "train_steady.json"), period=2, warm_steps=2)
    limits = _load("workloads", "bicycle_mcmc1m.train.json")["limits"]
    return SimpleNamespace(name="tiny.train", chips=1, config=cfg, traffic=traffic,
                           limits=limits)


def drive(control=False, seed=2**31 + 12345, device="cpu", **size):
    from portbench.drivers import train

    return train.run(tiny(**size), seed, 0.2, False, device, 0.0, control=control)


def test_sound_run_is_correct(cache):
    out = drive()
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_control_is_not_correct(cache):
    # bfloat16 rounds pixel coordinates more coarsely the larger the image:
    # the control needs an image nearer the cell's to show
    out = drive(control=True, width=256, height=192)
    assert not out["correct"], out["compared"]


def test_state_unchanged(cache, monkeypatch):
    from tdgs_torch.strategy import MCMCStrategy
    from tdgs_torch.training import trainer

    monkeypatch.setattr(trainer.SplatOptimizer, "update",
                        lambda self, g, state, params, lr, visibility=None: (params, state))
    monkeypatch.setattr(MCMCStrategy, "step_post_backward",
                        lambda self, p, o, s, *a, **k: (p, o, s))
    assert not drive()["correct"]


def test_half_batch(cache, monkeypatch):
    from tdgs_torch.training import losses

    inner = losses.d_ssim_l1_loss

    def half(pred, target, lam=0.2):
        h = pred.shape[-3] // 2
        return inner(pred[..., :h, :, :], target[..., :h, :, :], lam)

    monkeypatch.setattr(losses, "d_ssim_l1_loss", half)
    assert not drive()["correct"]


def test_uniform_draw(cache, monkeypatch):
    """The reference relocates from the system's own sources, so only the
    draw's law catches a draw that ignores opacity: at this size its z
    reads about 75, over the limit of 50 (a sound draw about 1-2)."""
    from tdgs_torch.strategy import mcmc

    monkeypatch.setattr(mcmc, "mcmc_sample_sources", control.uniform_draw)
    out = drive(n_gauss=20000)
    assert out["compared"]["reloc_gap"]["value"] <= out["compared"]["reloc_gap"]["limit"]
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("z_of", ["sound", "dead_source"])
def test_draw_z(z_of):
    import torch

    from portbench.drivers.train import draw_z

    g = torch.Generator().manual_seed(3)
    logits = torch.randn(50000, generator=g)
    logits[:2000] = -8.0
    op = torch.sigmoid(logits)
    src = torch.multinomial(torch.where(op > 0.005, op, torch.zeros_like(op)), 50000,
                            replacement=True, generator=g)
    if z_of == "sound":
        assert draw_z(logits, src) < 5.0
    else:
        src[7] = 0
        assert draw_z(logits, src) == float("inf")


@pytest.mark.cuda
def test_sound_run_on_the_card_is_correct(card, cache):
    """The same small cell through the system's kernels on the card."""
    out = drive(seed=2**31 + 777, device=card)
    assert out["correct"], out["compared"]
