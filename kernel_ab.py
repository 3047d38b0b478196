"""Ablation and A/B of the 2DGS compositing kernels 5 (the training call)
and 4 (the inference call) on the card, against the sources of an earlier
commit, at the bench frame's shapes and at trainer_2dgs's.

    git archive ee5fcef tdgs_torch/csrc | tar -x -C tdgs_torch/build/prev
    python3 kernel_ab.py tdgs_torch/build/prev/tdgs_torch/csrc

The ablation's patches anchor on the kernels' design at commit ee5fcef,
before their redesign. Builds with nvcc, one process per variant, all
started together:
- from the earlier kernels 4 and 5 (one source), the ablation variants (a)
  as it was, (b) batch 0 staged once and walked for every batch, (c) the
  reciprocal of tmpz by __fdividef in place of __frcp_rn (timing only),
  and (d) a counting build of (a), which reads per warp and entry offered
  whether a lane of the warp reaches alpha >= 1/255 there (with and
  without its own cutoff: the ceiling of any per-warp cull) and whether
  kernel 6's bound (surfel_cull.cuh, this tree's) keeps the entry.
- from this tree's kernels 4 and 5, a build as they are (called as every
  variant is, into one output made beforehand: the yardstick of the
  variants; "tree" goes through the wrapper), the design without its
  cull, with synchronous staging, kernel 4 reading rows gathered into
  stream order in place of reading through flatten_ids (the gather of the
  earlier inference path timed beside), with its registers capped at 48,
  and a counting build of its cull's kept share (each called at the
  wrapper's blocks a tile); and through the wrapper at 1, 2 and 4 blocks
  a tile.
- the earlier and this tree's kernel 6, whose cull moved into the shared
  header: its bits and its time.
A variant that overrides a header gets a copy of this tree's csrc with the
override, so that every source that includes the header sees it. Each
kernel's variants run on the same inputs and are timed twice by
chip_smoke.time_ms and twice by chip_smoke.graph_ms, in turns from the
first to the last and back. Their outputs are held against the plain
version, against a second launch (bit for bit) and against this tree's
kernel. Prints one JSON line per kernel and shape. Needs a CUDA card; the
port does not use this script.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as C
from tdgs_torch.models.gaussians import create_splats
from tdgs_torch.ops import _build
from tdgs_torch.ops import rasterize_2dgs_packed as R2
from tdgs_torch.ops import rasterize_packed as P
from tdgs_torch.utils.test_data import make_rich_scene

OUT = _build.BUILD_DIR / "kernel_ab"
ABLATION = {0: "a_committed", 1: "b_batch0_staged_once", 2: "c_approximate_reciprocal"}
N_COUNTS = 8
SPLITS = (1, 2, 4)  # blocks a tile, forced through the wrappers
PTXAS = {}  # variant -> {kernel entry: registers} of its build
TRAINER_SHAPE = dict(width=1236, height=822, n_surfels=40_000)

# counters a counting build adds: N_COUNTS sums over the launch
COUNTERS = f'''
__device__ unsigned long long g_counts[{N_COUNTS}];
extern "C" int abl_counts(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_counts, sizeof(g_counts));
}}
extern "C" int abl_reset() {{
  unsigned long long z[{N_COUNTS}] = {{0}};
  return (int)cudaMemcpyToSymbol(g_counts, z, sizeof(z));
}}
'''

ABL_HEAD = "#ifndef ABL\n#define ABL 0\n#endif\n#if ABL_COUNT\n" + COUNTERS + "#endif\n"

# the walk of a counting build: every lane evaluates every entry offered,
# the warp votes, lane 0 counts (offered, with a lane reaching alpha >=
# 1/255, with such a lane not yet past its cutoff, with a lane walking,
# kept by kernel 6's bound, reached but dropped by it) and each walking
# pixel counts its evaluations and live ones
COUNT_WALK = '''    for (int k = 0; k < n; ++k) {
      const float* row = s_rows + k * F;
      Response r;
      const float sigma = ray_splat_sigma(row, fx, fy, r);
      const float alpha = fminf(kAlphaClamp, __fmul_rn(row[11], expf(-sigma)));
      const bool pass = !(alpha < kAlphaThreshold);
      float g[kGeomCols];
#pragma unroll
      for (int j = 0; j < kGeomCols; ++j) g[j] = row[j];
      const bool kept = tdgssurfel::may_reach(g, x0, x1, y0, y1);
      const unsigned v_any = __ballot_sync(0xffffffffu, inside && pass);
      const unsigned v_live = __ballot_sync(0xffffffffu, !done && pass);
      const unsigned v_walk = __ballot_sync(0xffffffffu, !done);
      if ((threadIdx.x & 31) == 0) {
        ++c_offered;
        c_any += v_any != 0u;
        c_live_warp += v_live != 0u;
        c_walk_warp += v_walk != 0u;
        c_kept += kept;
        c_dropped_reaching += v_any != 0u && !kept;
      }
      if (done) continue;
      ++c_eval;
      if (!pass) continue;
      ++c_live;
      const float next_T = __fmul_rn(T, __fsub_rn(1.f, alpha));
      if (next_T <= kTransmittanceEps) {
        done = true;
        continue;
      }
      const float w = __fmul_rn(alpha, T);
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c < DA) acc[c] += w * row[kGeomCols + c];
      }
      T = next_T;
    }
'''
COUNT_DECL = '''#if ABL_COUNT
  unsigned long long c_offered = 0, c_any = 0, c_live_warp = 0, c_walk_warp = 0, c_eval = 0,
                     c_live = 0, c_kept = 0, c_dropped_reaching = 0;
  float x0 = fx, x1 = fx, y0 = fy, y1 = fy;
  for (int o = 16; o > 0; o >>= 1) {
    x0 = fminf(x0, __shfl_xor_sync(0xffffffffu, x0, o));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, o));
    y0 = fminf(y0, __shfl_xor_sync(0xffffffffu, y0, o));
    y1 = fmaxf(y1, __shfl_xor_sync(0xffffffffu, y1, o));
  }
#endif
'''
COUNT_FLUSH = '''#if ABL_COUNT
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&g_counts[0], c_offered);
    atomicAdd(&g_counts[1], c_any);
    atomicAdd(&g_counts[2], c_live_warp);
    atomicAdd(&g_counts[3], c_walk_warp);
    atomicAdd(&g_counts[6], c_kept);
    atomicAdd(&g_counts[7], c_dropped_reaching);
  }
  atomicAdd(&g_counts[4], c_eval);
  atomicAdd(&g_counts[5], c_live);
#endif
'''
COUNT_NAMES = ("warp_entries_offered", "with_a_lane_reaching_1_255",
               "with_such_a_lane_before_its_cutoff", "with_a_lane_walking",
               "pixel_entry_evaluations", "live_evaluations", "kept_by_surfel_cull",
               "reaching_but_dropped_by_surfel_cull")
# this tree's counting build: per warp and batch, the entries offered and
# kept by its cull, then the (pixel, entry) evaluations
TREE_COUNT_NAMES = ("warp_entries_offered", "kept", None, None, "pixel_entry_evaluations")


def _sub(text, old, new):
    if text.count(old) != 1:
        raise ValueError(f"patch anchor found {text.count(old)} times: {old[:60]!r}")
    return text.replace(old, new)


def _between(text, first, last):
    """(start, end) of the span from ``first`` to the end of ``last``."""
    i0 = text.index(first)
    return i0, text.index(last, i0) + len(last)


def _header_text(header):
    """A header's text to inline: no ``#pragma once``, no includes."""
    lines = _sub(header, "#pragma once\n", "").splitlines(keepends=True)
    return "".join(line for line in lines if not line.startswith("#include"))


def ablation_source(text, common, cull):
    """The earlier kernels 4 and 5 with the ABL switch: (b) batch 0 staged
    once, (c) the reciprocal of tmpz by __fdividef (the common header
    inlined and patched), and with ABL_COUNT the counting walk, which
    tests kernel 6's bound (this tree's ``cull`` header, inlined)."""
    s = _sub(text, "namespace {\n", ABL_HEAD + "namespace {\n")
    common = _sub(common, "#pragma once\n", "")
    common = _sub(common, "r.rtz = __frcp_rn(r.bad ? 1.f : tmpz);",
                  "\n#if ABL == 2\n  r.rtz = __fdividef(1.f, r.bad ? 1.f : tmpz);\n#else\n"
                  "  r.rtz = __frcp_rn(r.bad ? 1.f : tmpz);\n#endif\n")
    s = _sub(s, '#include "rasterize_2dgs_common.cuh"\n', common + _header_text(cull))
    copy = "    for (int i = tid; i < n * F; i += block) s_rows[i] = src[i];\n"
    s = _sub(s, copy, "#if ABL == 1\n    if (b0 == 0)\n#endif\n" + copy)
    i0, i1 = _between(s, "    for (int k = 0; k < n && !done; ++k) {\n",
                      "      T = next_T;\n    }\n")
    s = s[:i0] + "#if ABL_COUNT\n" + COUNT_WALK + "#else\n" + s[i0:i1] + "#endif\n" + s[i1:]
    s = _sub(s, "  for (int b0 = 0; b0 < count; b0 += block) {\n",
             COUNT_DECL + "  for (int b0 = 0; b0 < count; b0 += block) {\n")
    return _sub(s, "  if (!inside) return;\n", COUNT_FLUSH + "  if (!inside) return;\n")


def _sync_row_stage():
    """row_stage.cuh with synchronous copies in place of cp.async."""
    stage = (_build.CSRC_DIR / "row_stage.cuh").read_text()
    dst = "f < G ? batch + GP * lane + f : batch + GP * kBatch + lane * DP + (f - G)"
    stage = _sub(stage, f"      tdgsasync::copy_4({dst},\n                        src(f));",
                 f"      *({dst}) = *src(f);")
    stage = _sub(stage, "        tdgsasync::copy_16(batch + GP * lane + 4 * u, row + 4 * u);",
                 "        *reinterpret_cast<float4*>(batch + GP * lane + 4 * u) = "
                 "*reinterpret_cast<const float4*>(row + 4 * u);")
    return _sub(stage, f"        tdgsasync::copy_4({dst},\n                          row + f);",
                f"        *({dst}) = row[f];")


def tree_variants():
    """{name: {file: text}}: this tree's kernels 4 and 5 as they are, each
    without one part of its design or with one changed, as overrides of
    this tree's csrc (``rasterize_2dgs_fwd.cu`` is the source built);
    counting builds end in _counters."""
    fwd = (_build.CSRC_DIR / "rasterize_2dgs_fwd.cu").read_text()
    walk = (_build.CSRC_DIR / "surfel_walk.cuh").read_text()
    cull = "      may = may_reach(g, pix.x0, pix.x1, pix.y0, pix.y1);\n"
    count = _sub(walk, "namespace tdgssurfel {\n", COUNTERS + "namespace tdgssurfel {\n")
    count = _sub(count, "  if (count > 0) stage(0, s_batches);\n",
                 "  unsigned long long c_offered = 0, c_kept = 0, c_eval = 0;\n"
                 "  if (count > 0) stage(0, s_batches);\n")
    count = _sub(count, "    while (todo != 0u) {\n",
                 "    if (lane == 0) {\n      c_offered += n;\n      c_kept += __popc(todo);\n"
                 "    }\n    while (todo != 0u) {\n")
    count = _sub(count, "      if (c.done) continue;\n", "      if (c.done) continue;\n"
                 "      ++c_eval;\n")
    count = _sub(count, "  tdgsasync::wait<0>();  // a batch still in flight after an early "
                 "exit\n", "  tdgsasync::wait<0>();\n  if (lane == 0) {\n"
                 "    atomicAdd(&g_counts[0], c_offered);\n    atomicAdd(&g_counts[1], c_kept);\n"
                 "  }\n  atomicAdd(&g_counts[4], c_eval);\n")
    variants = {
        # built and called as every variant is: the fair yardstick for them
        "as_is": {},
        "no_cull": {"surfel_walk.cuh": _sub(walk, cull, "      may = true;\n")},
        "sync_staging": {"row_stage.cuh": _sync_row_stage()},
        # kernel 4 on rows gathered into stream order: the stream position
        # in place of the gaussian id
        "k4_gathered_rows": {"rasterize_2dgs_fwd.cu": _sub(
            fwd, "      return from + lane < count ? flatten_ids[start + from + lane] : -1;\n",
            "      return from + lane < count ? start + from + lane : -1;\n")},
        "capped_48": {"rasterize_2dgs_fwd.cu": _sub(
            fwd, "__global__ void rasterize_2dgs_fwd_kernel(",
            "__global__ void __maxnreg__(48) rasterize_2dgs_fwd_kernel(")},
        "cull_counters": {"surfel_walk.cuh": count},
    }
    return variants


def _variant_dir(name, overrides):
    """A copy of this tree's csrc headers and kernel 4/5 source with
    ``overrides``; returns the source to build."""
    d = OUT / f"src_{name}"
    d.mkdir(parents=True, exist_ok=True)
    for p in list(_build.CSRC_DIR.glob("*.cuh")) + [_build.CSRC_DIR / "rasterize_2dgs_fwd.cu"]:
        (d / p.name).write_text(overrides.get(p.name, p.read_text()))
    return d / "rasterize_2dgs_fwd.cu"


def build_all(prev: Path):
    """Every variant, one nvcc each, all started together; {name: CDLL}."""
    OUT.mkdir(parents=True, exist_ok=True)
    earlier = ["-I", str(prev)]
    jobs = {}
    src = OUT / "ablation_2dgs_fwd.cu"
    src.write_text(ablation_source((prev / "rasterize_2dgs_fwd.cu").read_text(),
                                   (prev / "rasterize_2dgs_common.cuh").read_text(),
                                   (_build.CSRC_DIR / "surfel_cull.cuh").read_text()))
    for m, variant in ABLATION.items():
        jobs[variant] = (src, [f"-DABL={m}", *earlier])
    jobs["d_counters"] = (src, ["-DABL=0", "-DABL_COUNT=1", *earlier])
    jobs["earlier_rasterize_2dgs_bwd"] = (prev / "rasterize_2dgs_bwd.cu", earlier)
    for name, overrides in tree_variants().items():
        src = _variant_dir(name, overrides)
        jobs[name] = (src, ["-I", str(src.parent)])
    procs = {}
    for name, (src, flags) in jobs.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(OUT / f"lib{name}.so"),
               str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(json.dumps({"nvcc_failed": name, "log": log[-2000:]}), flush=True)
            continue
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        PTXAS[name] = _registers(log)
    return libs


def _registers(log):
    """{kernel entry: registers} from ptxas's -v output."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and "registers" in line and entry is not None:
            out[entry] = int(line.split("Used")[1].split("registers")[0])
    return out


def _call(fn, *args):
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
    if err != 0:
        raise RuntimeError(f"launch failed with cudaError_t {err}")


def _entry(lib, name, n_ptrs, n_ints, slots=False):
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + ([ctypes.c_int64] if slots else []) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _counts(lib, run, names=COUNT_NAMES):
    """A counting build's sums over one launch, by slot: {name: sum} for
    each named slot (None skips one)."""
    lib.abl_counts.argtypes = [ctypes.c_void_p]
    lib.abl_reset()
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * N_COUNTS)()
    lib.abl_counts(buf)
    return {name: v for name, v in zip(names, list(buf)) if name is not None}


def _flat(out):
    return torch.cat([o.reshape(-1) for o in out]) if isinstance(out, tuple) else out


def compare(kernel, fns, plain=None, reps=20):
    """Each variant against the plain version (max|Δ| over the outputs
    ``plain`` holds, the first of each call's), a second launch and the
    tree's kernel (``fns["tree"]``) bit for bit. Times in turns, there and
    back, by CUDA events around back-to-back calls and by the replay of the
    same calls from a CUDA graph."""
    ref = _flat(fns["tree"]()).clone()
    agree = {}
    for name, fn in fns.items():
        out = fn()
        first, second = _flat(out).clone(), _flat(fn()).clone()
        torch.cuda.synchronize()
        agree[name] = dict(repeat_bitwise=bool(torch.equal(first, second)),
                           bitwise_vs_tree=bool(torch.equal(first, ref)))
        if plain is not None:
            agree[name]["max_abs_err_vs_plain"] = C._abs_err(_flat(out[:len(plain)]),
                                                             _flat(plain))
    warm_up(fns["tree"])
    order = list(fns)
    times = {name: [] for name in fns}
    graphs = {name: [] for name in fns}
    for name in order + order[::-1]:
        times[name].append(C.time_ms(fns[name], reps))
        graphs[name].append(C.graph_ms(fns[name], reps))
    return dict(kernel=kernel, times_ms=times, graph_ms=graphs, agree=agree)


def warm_up(fn, seconds=0.5):
    """Runs fn back to back for ``seconds``, so that the card's clocks have
    risen before the first timing."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()


def tile_stats(offsets, max_entries):
    """The distribution of entries per tile."""
    n = torch.clamp(torch.diff(offsets.long()), 0, max_entries).double()
    return dict(tiles=int(n.numel()), entries=int(n.sum()), mean=float(n.mean()),
                p50=float(n.quantile(0.5)), p99=float(n.quantile(0.99)), max=float(n.max()),
                empty=int((n == 0).sum()))


def trainer_scene(width, height, n_surfels, seed=11):
    """trainer_2dgs's first step: the rich scene's camera 0 at its image
    size, with ``n_surfels`` of its ground-truth points initialised as the
    Runner initialises SfM points (3-NN scales, opacity 0.1, SH degree 3
    from the colours)."""
    with tempfile.TemporaryDirectory() as root:
        sc = make_rich_scene(root, n_images=1, width=width, height=height, device=C.DEVICE)
    rng = np.random.default_rng(seed)
    sel = rng.choice(sc["means"].shape[0], size=n_surfels, replace=False)
    g = torch.Generator(device=C.DEVICE).manual_seed(seed)
    pts = torch.as_tensor(sc["means"][sel], device=C.DEVICE)
    rgb = torch.as_tensor(sc["colors"][sel], device=C.DEVICE)
    p = create_splats(pts, rgb, g, sh_degree=3)
    return dict(means=p["means"], quats=p["quats"], scales=torch.exp(p["scales"]),
                opacities=torch.sigmoid(p["opacities"]), sh=torch.cat([p["sh0"], p["shN"]], 1),
                viewmats=torch.as_tensor(sc["viewmats"][:1], device=C.DEVICE),
                Ks=torch.as_tensor(sc["Ks"][:1], device=C.DEVICE))


def run_k5(libs, shape, geo):
    """Kernel 5 (RGB+ED with the distortion) on stream-order rows ``geo``."""
    rows, offsets, I, D, W, H, ts = geo
    tw, th = -(-W // ts), -(-H // ts)
    max_e = P.max_entries_per_tile(1024)
    plain = R2.rasterize_2dgs_fwd_plain(*geo, 1024, D - 1, True)[:5]
    # this tree's builds cut tiles into the blocks the wrapper does
    R2.rasterize_2dgs_train_fwd(*geo, 1024, D - 1, True)
    n_split = R2.BLOCKS_A_TILE[R2.KERNEL_TRAIN]

    def out_like():
        return tuple(torch.empty_like(x) for x in plain)

    def earlier(lib):
        fn = _entry(lib, "tdgs_rasterize_2dgs_fwd_train", 7, 10)
        out = out_like()
        return lambda: _call(fn, rows, offsets, *out, I, W, H, ts, tw, th, D, max_e, D - 1,
                             1) or out

    def tree(lib):
        fn = _entry(lib, "tdgs_rasterize_2dgs_fwd_train", 7, 11)
        out = out_like()
        return lambda: _call(fn, rows, offsets, *out, I, W, H, ts, tw, th, D, max_e, D - 1,
                             1, n_split) or out

    fns = {v: earlier(libs[v]) for v in ABLATION.values() if v in libs}
    fns.update({name: tree(lib) for name, lib in libs.items()
                if name in tree_variants() and "counters" not in name
                and not name.startswith("k4_")})
    for s in SPLITS:
        fns[f"tree_split_{s}"] = (lambda n: lambda: R2.rasterize_2dgs_train_fwd(
            *geo, 1024, D - 1, True, n_split=n))(s)
    fns["tree"] = lambda: R2.rasterize_2dgs_train_fwd(*geo, 1024, D - 1, True)
    # colours, normals and T against the plain version (TOL)
    result = compare("k5", fns, plain[:3])
    counts = {"a_committed": _counts(libs["d_counters"], earlier(libs["d_counters"]))}
    if "cull_counters" in libs:
        counts["tree_cull"] = _counts(libs["cull_counters"], tree(libs["cull_counters"]),
                                      TREE_COUNT_NAMES)
    result.update(shape=shape, D=D, n_split=n_split, stream=tile_stats(offsets, max_e),
                  counts=counts)
    print(json.dumps(result), flush=True)


def run_k4(libs, shape, k4):
    """Kernel 4 ("RGB", no background, as the bench render) on per-gaussian
    rows read through flatten_ids; the earlier kernel and the gathered-rows
    variant on the rows gathered into stream order, which the gather of
    the earlier inference path made (timed too)."""
    feats, ids, offsets, I, D, W, H, ts = k4
    tw, th = -(-W // ts), -(-H // ts)
    max_e = P.max_entries_per_tile(1024)
    F = R2.GEOM_COLS + D + 3
    feats_f = feats[:, :F].contiguous()
    rows = feats_f[ids.long()]  # the earlier path's gather: [L, F]
    rows_padded = feats[ids.long()]  # the same, at the kernel's row stride
    geo = (rows, offsets, I, D, W, H, ts)
    plain = R2.rasterize_2dgs_fwd_plain(*geo, 1024)
    plain = (plain[0], (1.0 - plain[2])[..., None], plain[1])
    R2.rasterize_2dgs_inference(*k4)
    n_split = R2.BLOCKS_A_TILE[R2.KERNEL_FWD]

    def out_like():
        return tuple(torch.empty_like(x) for x in plain)

    def earlier(lib):
        fn = _entry(lib, "tdgs_rasterize_2dgs_fwd", 6, 8)
        out = out_like()
        return lambda: _call(fn, rows, offsets, None, out[0], out[2], out[1], I, W, H, ts, tw,
                             th, D, max_e) or out

    def tree(lib, src):
        fn = _entry(lib, "tdgs_rasterize_2dgs_fwd", 7, 10)
        out = out_like()
        return lambda: _call(fn, src, ids, offsets, None, out[0], out[2], out[1], I, W, H, ts,
                             tw, th, D, max_e, src.shape[1], n_split) or out

    fns = {v: earlier(libs[v]) for v in ABLATION.values() if v in libs}
    fns.update({name: tree(lib, rows_padded if name.startswith("k4_") else feats)
                for name, lib in libs.items()
                if name in tree_variants() and "counters" not in name})
    for s in SPLITS:
        fns[f"tree_split_{s}"] = (lambda n: lambda: R2.rasterize_2dgs_inference(
            *k4, n_split=n))(s)
    fns["tree"] = lambda: R2.rasterize_2dgs_inference(*k4)
    result = compare("k4", fns, plain)
    gather = lambda: feats_f[ids.long()]  # noqa: E731
    result["earlier_gather"] = dict(ms=C.time_ms(gather, 20), graph_ms=C.graph_ms(gather, 20),
                                    bytes_written=rows.numel() * 4)
    counts = {"a_committed": _counts(libs["d_counters"], earlier(libs["d_counters"]))}
    if "cull_counters" in libs:
        counts["tree_cull"] = _counts(libs["cull_counters"],
                                      tree(libs["cull_counters"], feats), TREE_COUNT_NAMES)
    result.update(shape=shape, D=D, n_split=n_split, stream=tile_stats(offsets, max_e),
                  counts=counts)
    print(json.dumps(result), flush=True)


def run_k6(libs, geo):
    """Kernel 6 built from the earlier source and from this tree's, on the
    same inputs (kernel 5's outputs, random cotangents): bits and times."""
    rows, offsets, I, D, W, H, ts = geo
    tw, th = -(-W // ts), -(-H // ts)
    max_e = P.max_entries_per_tile(1024)
    train = R2.rasterize_2dgs_train_fwd(*geo, 1024, D - 1, True)
    g = torch.Generator(device=C.DEVICE).manual_seed(5)
    cot = [torch.randn(x.shape, generator=g, device=C.DEVICE) for x in train[:4]]
    L = rows.shape[0]

    def k6(lib):
        fn = _entry(lib, "tdgs_rasterize_2dgs_bwd", 11, 10, slots=True)
        out = torch.empty_like(rows)
        return lambda: _call(fn, rows, offsets, *train[:4], *cot, out, I, W, H, ts, tw, th, D,
                             max_e, D - 1, 1, L) or out

    fns = {"earlier": k6(libs["earlier_rasterize_2dgs_bwd"]),
           "tree": k6(_build.load(R2.KERNEL_BWD))}
    result = compare("k6", fns)
    result.update(shape="bench")
    print(json.dumps(result), flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    if len(argv) != 1:
        raise SystemExit("usage: python3 kernel_ab.py <earlier tdgs_torch/csrc>")
    t0 = time.perf_counter()
    prev = Path(argv[0]).resolve()
    _build.build()
    libs = build_all(prev)
    tree = {name: _registers(log) for name, log in _build.BUILD_LOGS.items()}
    print(json.dumps({"device": C.nvidia_smi(), "build_s": time.perf_counter() - t0,
                      "ptxas": PTXAS, "ptxas_tree": tree}), flush=True)
    bench = C.to_card(C.bench_scene())
    cap = C.bench_capacity_2dgs(bench)
    kw = dict(tile_capacity=1024, max_tiles_per_gauss=16, isect_capacity=cap)
    (geo, _), _ = C.kernel_inputs_2dgs(bench, **kw)
    run_k5(libs, "bench", geo)
    (_, k4), _ = C.kernel_inputs_2dgs(bench, render_mode="RGB", distloss=False, **kw)
    run_k4(libs, "bench", k4)
    run_k6(libs, geo)
    trainer = trainer_scene(**TRAINER_SHAPE)
    shape = dict(width=TRAINER_SHAPE["width"], height=TRAINER_SHAPE["height"])
    (geo_t, _), _ = C.kernel_inputs_2dgs(trainer, tile_capacity=1024, **shape)
    run_k5(libs, "trainer", geo_t)
    (_, k4_t), _ = C.kernel_inputs_2dgs(trainer, render_mode="RGB", distloss=False,
                                        tile_capacity=1024, **shape)
    run_k4(libs, "trainer", k4_t)
    print(json.dumps({"seconds": time.perf_counter() - t0, "device": C.nvidia_smi()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
