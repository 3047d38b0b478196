"""``layer_split``'s reading of a trace, on a small synthetic one: each
device operation goes to the innermost span open at its launch (on any
thread), busy time and idle gaps by layer, synchronising calls by the site
of their ``sync`` span; and the readings are None where nothing was read."""

import pytest
import torch

from portbench import layer_split

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, s, e, dev=CPU, corr=0, thread=1):
        self._n, self._s, self._e, self._d, self._c, self._t = name, s, e, dev, corr, thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t


def trace():
    """Host (ns): step 0-1000 holds render 0-300 (its child composite
    100-250, a sync 200-240 inside it), backward 300-700 and adam 700-900.
    The backward's kernel is launched from autograd's thread (2); one
    kernel is launched before the step; the render's range also comes as a
    device event, which is left out."""
    host = [Ev("span:step", 0, 1000), Ev("span:render", 0, 300),
            Ev("span:composite", 100, 250), Ev("span:sync", 200, 240),
            Ev("span:backward", 300, 700), Ev("span:adam", 700, 900),
            Ev("aten::item", 195, 245)]
    launches = [Ev("cudaLaunchKernel", -50, -40, corr=1),
                Ev("cudaLaunchKernel", 120, 125, corr=2),
                Ev("cudaMemcpyAsync", 205, 210, corr=3),
                Ev("cudaStreamSynchronize", 210, 238, corr=4),
                Ev("cudaLaunchKernel", 400, 405, corr=5, thread=2),
                Ev("cudaLaunchKernel", 750, 755, corr=6),
                Ev("cudaStreamSynchronize", 960, 990, corr=7)]
    device = [Ev("early_kernel", 0, 100, CUDA, 1),
              Ev("rasterize_packed_fwd_kernel", 130, 200, CUDA, 2),
              Ev("Memcpy DtoH (Device -> Pageable)", 215, 220, CUDA, 3),
              Ev("rasterize_packed_bwd_kernel", 500, 600, CUDA, 5),
              Ev("adam_kernel", 760, 800, CUDA, 6),
              Ev("lost_kernel", 900, 950, CUDA, 99),
              # the profiler's device copy of a host range: not work
              Ev("span:render", 130, 220, CUDA, 0)]
    return host + launches + device


def test_launch_spans_innermost_on_any_thread():
    attr = layer_split.launch_spans(trace())
    owner = {name: span for name, span, _, _ in attr["ops"]}
    assert owner == {"early_kernel": None, "rasterize_packed_fwd_kernel": "composite",
                     "Memcpy DtoH (Device -> Pageable)": "sync",
                     "rasterize_packed_bwd_kernel": "backward", "adam_kernel": "adam",
                     "lost_kernel": None}
    assert attr["unlaunched"] == 1
    chains = dict(zip([o[0] for o in attr["ops"]], attr["chains"]))
    assert chains["rasterize_packed_fwd_kernel"] == ("step", "render", "composite")
    busy = layer_split.busy_by_layer(attr, ("render", "backward", "adam", "loss"))
    assert busy["render"] == pytest.approx(75e-9)  # 70 + the copy's 5
    assert busy["backward"] == pytest.approx(100e-9)
    assert busy["adam"] == pytest.approx(40e-9) and busy["loss"] == 0.0
    assert busy[None] == pytest.approx(150e-9)
    # gaps: 100-130 (render), 200-215 (sync), 220-500 (mid 360, backward),
    # 600-760 (mid 680, backward), 800-900 (mid 850, adam); all covered
    idle, free = layer_split.idle_gaps(attr)
    assert idle == pytest.approx((30 + 15 + 280 + 160 + 100) * 1e-9) and free == 0.0


def test_idle_gap_outside_every_span_is_unattributed():
    evs = [Ev("span:step", 0, 100), Ev("cudaLaunchKernel", 10, 11, corr=1),
           Ev("cudaLaunchKernel", 20, 21, corr=2), Ev("k", 30, 50, CUDA, 1),
           Ev("k", 300, 320, CUDA, 2)]
    idle, free = layer_split.idle_gaps(layer_split.launch_spans(evs))
    assert idle == pytest.approx(250e-9) and free == pytest.approx(250e-9)


def test_sync_calls_by_site():
    got = layer_split.sync_calls(trace(), ["tile_sort"])
    assert got == {"tile_sort": {"dtoh_copy": 1, "wait": 1}, "no host_read: step": {"wait": 1}}


def test_metrics_none_without_readings_and_per_step_with():
    empty = layer_split.metrics(None, None, 0)
    assert len(empty) == 11 and all(v is None for v in empty.values())
    program = {"steps": 2, "spans": {"render": {"incl_s": 0.02}, "loss": {"incl_s": 0.004},
                                     "backward": {"incl_s": 0.01}, "adam": {"incl_s": 0.006},
                                     "sync": {"incl_s": 0.002}},
               "counts": {"host_sync": {"tile_sort": 2, "log": 3}}}
    got = layer_split.metrics(program, layer_split.launch_spans(trace()), 1)
    assert got["render_host_ms.train"] == pytest.approx(10.0)
    assert got["adam_host_ms.train"] == pytest.approx(3.0)
    assert got["host_syncs.train"] == 2.5 and got["sync_wait_ms.train"] == pytest.approx(1.0)
    assert got["backward_busy_ms.train"] == pytest.approx(1e-4)
    assert got["loss_busy_ms.train"] == 0.0 and got["idle_unattributed_ms.train"] == 0.0


def test_measure_on_a_tiny_cell_on_the_cpu(cache):
    from portbench.tests.test_portbench_checks import tiny

    cell = tiny()
    cell.traffic.update(trace_steps=2, period=10)
    got = layer_split.measure(cell, 2**31 + 7, 1, torch.device("cpu"))
    m = got["metrics"]
    assert all(m[f"{k}_host_ms.train"] > 0 for k in layer_split.LAYERS)
    # a tile sort a step; no device, so no device reading
    assert m["host_syncs.train"] >= 1 and m["sync_wait_ms.train"] > 0
    assert m["render_busy_ms.train"] is None and m["idle_unattributed_ms.train"] is None
    assert got["traced"]["host_syncs"]["tile_sort"] == 2
    assert got["program_period"]["counts"]["host_sync"]["tile_sort"] == 10
    # 10 steps: 5 off, then 5 on; the last has no next batch to end it
    cost = got["on_cost"]
    assert len(cost["off_ms"]) == 5 and len(cost["on_ms"]) == 4
    assert cost["call_ns"]["span_on"] > cost["call_ns"]["span_off"] > 0
    assert got["beside_benchmark_spans"]["data"]["program_ms"] > 0
