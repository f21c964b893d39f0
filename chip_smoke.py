"""Smoke run of the PyTorch/CUDA port (gpsat_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # one card; exits non-zero on any failure
    python3 chip_smoke.py --profile    # also write torch.profiler tables of one
                                       # main-path, one panel-path and one
                                       # profiled-path run to
                                       # chiprun_out/profile*.txt, and split
                                       # kernel 3's time by __global__
    python3 chip_smoke.py --kernels    # phases 1 and 2 only (no result line)

Phases (each prints on its own lines; any failure raises):

1. build     compile gpsat_tpu_torch/csrc/{block_chol,panel_chol,cholesky}.cu
             with nvcc for sm_90a, all three at once
2. kernel    each CUDA kernel against its plain PyTorch version on the card at
             the shapes its path gives it ([512, 64, 64], [512, 128, 128],
             [512, 512, 512] f32; kernel 3 also at [8, 1024, 1024] and
             [8, 128, 128]), its contract cases (NaN or clamp, the identity),
             and CUDA-event times of the kernel, the plain version and one
             library call as the yardstick; kernels 1 and 2 are also timed
             back to back (20 launches between one event pair), which leaves
             out the wrapper's host time; every kernel reports its blocks per
             SM, and with --profile kernel 3 its device time per __global__
             function
3. main      bench.py's workload (B=512, N=512, P=64, D=2, Matern32, f32,
             single-eval L-BFGS) through the port's engine on the "block"
             route: a warm-up call, then one timed call with the kernels'
             launch counters set to 0 before it and read after it
4. accuracy  the first 16 tiles, f32 on the card against f64 on the CPU
   f64       the same 16 tiles in f64 on the card on the "block", "panel" and
             "cholesky" routes (the library arm of each: the kernels take f32
             only, and no kernel may launch), each within 1e-5 of phase 4's
             CPU f64 result
5. panel     phase 3's workload on the "panel" route (kernel 2 in the
             objective, kernel 3 in the predict), held against phase 3's
             predictions
6. profiled  phase 3's workload through the profiled-variance core (kernel 3
             in the objective and in finalize_params, kernel 1 in the
             predict); the first 8 tiles against the same core in f64 on the
             CPU, on the lanes where neither run collapsed to the pure-noise
             point

Then one {"kernels": [...]} line, and last {"ok": true, "device": {...}}.
Imports nothing of JAX or of gpsat_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
SECTOR_BYTES = 32  # the least the memory system moves at a time
B, N, P, D = 512, 512, 64, 2
T = 64
CPU_TILES = 16
PROFILED_CPU_TILES = 8
KERNELS = ("block_chol", "panel_chol", "cholesky")
# the __global__ functions of those sources, as the profiler names them
OWN_KERNELS = ("cholinv64_kernel", "panel128_kernel", "chol_")
# f32 card vs f64 CPU on predictions: raw f32 optima sit ~3e-3 from f64 gold
# (flat optima; the repo's accuracy logs), so 1e-2 catches a wrong path
# without failing on f32 hyperparameter drift
PRED_BOUND = 1e-2
# two f32 runs on the card from the same init, on different factor routes:
# trajectories may part (other roundoff), each ends within the f32 band of the
# same flat optimum, so the same bound holds between them
ROUTE_BOUND = 1e-2
# a lane of the profiled surface that ran to the pure-noise stationary point
# (lengthscales -> 0, about one lane in eight): every lengthscale far below
# the ~0.5 spacing of the workload's points
COLLAPSED_LS = 0.05
# at least this share of the compared tiles must be lanes where neither the
# card's f32 run nor the CPU's f64 run collapsed
MIN_COMPARED_SHARE = 0.5
RUN_KW = dict(max_iter=100, linesearch="single_eval", tol_grad=1e-3, tol_f=1e-6)
# the f64 runs: phase 4's CPU reference and phase f64 on the card
CPU_F64_KW = dict(linesearch="single_eval", tol_grad=1e-6, tol_f=1e-11)
# f64 on the card vs f64 on the CPU, the same fit in another summation
# order: the north star's band for predictions
F64_BOUND = 1e-5


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def time_ms(fn, reps=20, warm=3):
    """Median of per-call CUDA-event times (ms)."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bench_workload(dtype=np.float32):
    """bench.py's workload and explicit init (seed 0, 60-100 % fill)."""
    from gpsat_tpu_torch.parallel.batching import TileBatch

    rng = np.random.default_rng(0)
    X = rng.uniform(-6, 6, size=(B, N, D)).astype(dtype)
    y = (np.sin(X[..., 0]) * np.cos(X[..., 1]) + 0.1 * rng.normal(size=(B, N))).astype(dtype)
    mask = np.ones((B, N), dtype=dtype)
    fill = rng.integers(int(0.6 * N), N + 1, size=B)
    for i, f in enumerate(fill):
        mask[i, f:] = 0.0
    Xnew = rng.uniform(-4, 4, size=(B, P, D)).astype(dtype)
    batch = TileBatch(
        X=X, y=y, mask=mask, Xnew=Xnew, pred_mask=np.ones((B, P), dtype=dtype),
        obs_mean=np.zeros(B, dtype=dtype), expert_index=np.arange(B), num_obs=fill,
    )
    var_y = np.nanvar(np.where(mask > 0, y, np.nan), axis=1)
    init = {
        "lengthscales": np.nanstd(np.where(mask[..., None] > 0, X, np.nan), axis=1),
        "kernel_variance": var_y,
        "likelihood_variance": 0.1 * var_y,
    }
    return batch, init


def spd_batch(Bn, n, seed):
    """[Bn, n, n] f32 SPD matrices on the card: A A^T + n I, entries O(sqrt n)."""
    import torch

    A = torch.from_numpy(np.random.default_rng(seed).standard_normal((Bn, n, n)).astype(np.float32)).cuda()
    return torch.matmul(A, A.transpose(1, 2)) + n * torch.eye(n, device=A.device)


def factor_bytes(Bn, n, outputs):
    """Least bytes a factor of [Bn, n, n] f32 moves: the input's lower
    triangle read in whole 32-byte sectors (rows start on a sector), and
    ``outputs`` full n x n matrices written (their zero upper triangles too)."""
    per_sector = SECTOR_BYTES // 4
    read = sum(-(-(r + 1) // per_sector) for r in range(n)) * SECTOR_BYTES
    return Bn * (read + outputs * n * n * 4)


def kernel_entry(name, source, replaces, shape, err, ms, plain_ms, library_ms, nbytes, flops, row_extra=None,
                 **details):
    """One row of the {"kernels": [...]} line, with the kernel's bound: the
    larger of its bytes (what the function must read once and write once,
    ``factor_bytes``) over the card's memory rate and its operations over
    the f32 peak. ``row_extra`` adds keys to the row; ``details`` go to the
    log line only."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    log("kernel", name=name, shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms, **(row_extra or {}), **details)
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        **(row_extra or {}),
    }


def back_to_back_ms(fn, launches=20, reps=5):
    """Median over ``reps`` of (one event pair around ``launches`` calls) /
    ``launches``: the kernel's own time once the host runs ahead of it."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def device_ms_by_kernel(fn, match, calls=5):
    """Device time per call (ms) of each CUDA kernel whose name contains
    ``match``, from torch.profiler over ``calls`` calls of ``fn`` after one
    warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / calls for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and match in e.key}


def upper_is_zero(*mats):
    import torch

    return all(float(torch.triu(M, 1).abs().max()) == 0.0 for M in mats)


def phase_kernel(BC):
    import torch

    K = spd_batch(B, T, seed=0)
    L, W = BC.factor_blocks(K)
    torch.cuda.synchronize()
    Lr, Wr = BC.factor_blocks_reference(K)
    err_L = float((L - Lr).abs().max())
    err_W = float((W - Wr).abs().max())
    eye = torch.eye(T, device=K.device)
    err_LW = float((torch.matmul(L, W) - eye).abs().max())
    # f32, 64 dependent steps, FMA-contracted in the kernel and not in the
    # plain version; L entries are O(10): 1e-4 absolute
    check(err_L <= 1e-4 and err_W <= 1e-4, f"block kernel vs plain version: |dL| {err_L}, |dW| {err_W}")
    check(err_LW <= 1e-4, f"block kernel: max |LW - I| = {err_LW}")
    check(upper_is_zero(L, W), "block kernel: strict upper triangles not zero")
    bad = torch.stack([eye, -eye]).contiguous()
    Ln, Wn = BC.factor_blocks(bad)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(Ln[0]).all()) and bool(torch.isnan(Ln[1]).any()) and bool(torch.isnan(Wn[1]).any()),
          "a -I block must give NaN in L and W, an I block beside it finite values")
    check(torch.equal(Ln[0], eye) and torch.equal(Wn[0], eye), "an identity block must come back exactly")

    def library():
        Lc, _ = torch.linalg.cholesky_ex(K)
        return torch.linalg.solve_triangular(Lc, eye.expand(B, T, T), upper=False)

    # least work: read K's lower triangle once, write L and W once; Cholesky
    # T^3/3 + inverse T^3/3 flops
    return kernel_entry(
        "block_chol.factor_blocks", "gpsat_tpu_torch/csrc/block_chol.cu", "gpsat_tpu/ops/pallas/block_chol.py:50",
        [B, T, T], max(err_L, err_W), time_ms(lambda: BC.factor_blocks(K)),
        time_ms(lambda: BC.factor_blocks_reference(K)), time_ms(library),
        nbytes=factor_bytes(B, T, 2), flops=B * (2.0 / 3.0) * T**3,
        row_extra={"ms_back_to_back": back_to_back_ms(lambda: BC.factor_blocks(K)),
                   "library_ms_back_to_back": back_to_back_ms(library), "blocks_per_sm": BC.blocks_per_sm()},
        err_L=err_L, err_W=err_W, max_abs_LW_minus_I=err_LW, nan_case="ok", identity_case="ok",
    )


def phase_kernel_panel(PC):
    import torch

    TP = PC.T_PANEL
    K = spd_batch(B, TP, seed=1)
    L, W = PC.factor_panels(K)
    torch.cuda.synchronize()
    Lr, Wr = PC.factor_panels_reference(K)
    err_L = float((L - Lr).abs().max())
    err_W = float((W - Wr).abs().max())
    eye = torch.eye(TP, device=K.device)
    err_LW = float((torch.matmul(L, W) - eye).abs().max())
    err_LLt = float((torch.matmul(L, L.transpose(1, 2)) - K).abs().max())
    # f32, 128 dependent steps, FMA-contracted in the kernel and not in the
    # plain version; L entries are O(10), Linv entries O(0.1), K entries up to
    # ~300: the bounds the JAX package holds its kernel to (2e-4 on L, 2e-5 on
    # L Linv - I), 2e-5 on Linv, and 1e-5 of K's entries on L L^T
    check(err_L <= 2e-4 and err_W <= 2e-5, f"panel kernel vs plain version: |dL| {err_L}, |dW| {err_W}")
    check(err_LW <= 2e-5, f"panel kernel: max |L Linv - I| = {err_LW}")
    check(err_LLt <= 2e-3, f"panel kernel: max |L L^T - K| = {err_LLt}")
    check(upper_is_zero(L, W), "panel kernel: strict upper triangles not zero")
    # the contract is the 1e-30 pivot clamp: an all-zero block gives finite
    # values equal to the plain version's, the identity block beside it is exact
    odd = torch.stack([torch.zeros_like(eye), eye]).contiguous()
    Lz, Wz = PC.factor_panels(odd)
    torch.cuda.synchronize()
    Lzr, Wzr = PC.factor_panels_reference(odd)
    check(bool(torch.isfinite(Lz).all()) and bool(torch.isfinite(Wz).all()), "an all-zero block must give finite values")
    check(torch.allclose(Lz, Lzr, rtol=1e-6, atol=0) and torch.allclose(Wz, Wzr, rtol=1e-6, atol=0),
          "the clamp case differs from the plain version")
    check(torch.equal(Lz[1], eye) and torch.equal(Wz[1], eye), "an identity block must come back exactly")

    def library():
        Lc, _ = torch.linalg.cholesky_ex(K)
        return torch.linalg.solve_triangular(Lc, eye.expand(B, TP, TP), upper=False)

    return kernel_entry(
        "panel_chol.factor_panels", "gpsat_tpu_torch/csrc/panel_chol.cu", "gpsat_tpu/ops/pallas/panel_chol.py:41",
        [B, TP, TP], max(err_L, err_W), time_ms(lambda: PC.factor_panels(K)),
        time_ms(lambda: PC.factor_panels_reference(K), reps=5, warm=1), time_ms(library),
        nbytes=factor_bytes(B, TP, 2), flops=B * (2.0 / 3.0) * TP**3,
        row_extra={"ms_back_to_back": back_to_back_ms(lambda: PC.factor_panels(K)),
                   "library_ms_back_to_back": back_to_back_ms(library)},
        err_L=err_L, err_W=err_W, max_abs_LLinv_minus_I=err_LW, max_abs_LLt_minus_K=err_LLt, clamp_case="ok",
        blocks_per_sm=PC.blocks_per_sm(),
    )


def phase_kernel_cholesky(CH, profile: bool):
    import torch

    def compare(Bn, n, seed):
        K = spd_batch(Bn, n, seed)
        L = CH.cholesky(K)
        torch.cuda.synchronize()
        err = float((L - CH.cholesky_reference(K)).abs().max())
        err_LLt = float((torch.matmul(L, L.transpose(1, 2)) - K).abs().max())
        # f32 roundoff of this factorisation against f64 is ~2e-5 on L
        # (entries up to ~50) and ~1e-6 of K's entries (up to ~2n) on L L^T:
        # 2e-4 absolute against the plain version, 1e-5 of n on L L^T
        check(err <= 2e-4, f"cholesky kernel vs plain version at {[Bn, n, n]}: {err}")
        check(err_LLt <= 1e-5 * n, f"cholesky kernel: max |L L^T - K| at {[Bn, n, n]} = {err_LLt}")
        check(upper_is_zero(L), f"cholesky kernel: strict upper triangle not zero at {[Bn, n, n]}")
        return K, err, err_LLt

    K, err, err_LLt = compare(B, N, seed=2)
    edges = {str([Bn, n, n]): compare(Bn, n, seed=3)[1] for Bn, n in ((8, 1024), (8, 128))}
    eye = torch.eye(N, device=K.device)
    Ln = CH.cholesky(torch.stack([eye, -eye]).contiguous())
    torch.cuda.synchronize()
    check(torch.equal(Ln[0], eye) and bool(torch.isnan(Ln[1]).any()),
          "a -I matrix must give NaN, an I matrix beside it must come back exactly")

    # the host entry's __global__ functions (diagonal with its panel, trailing)
    split = device_ms_by_kernel(lambda: CH.cholesky(K), "chol_") if profile else None
    return kernel_entry(
        "cholesky.cholesky", "gpsat_tpu_torch/csrc/cholesky.cu", "gpsat_tpu/ops/pallas/cholesky.py:90",
        [B, N, N], err, time_ms(lambda: CH.cholesky(K)),
        time_ms(lambda: CH.cholesky_reference(K), reps=3, warm=1), time_ms(lambda: torch.linalg.cholesky_ex(K)),
        nbytes=factor_bytes(B, N, 1), flops=B * N**3 / 3.0,
        row_extra={"blocks_per_sm": CH.blocks_per_sm(), "device_ms_by_kernel": split},
        max_abs_LLt_minus_K=err_LLt, edge_max_abs_err=edges, nan_case="ok",
    )


def counters():
    from gpsat_tpu_torch.ops.block_chol import factor_blocks
    from gpsat_tpu_torch.ops.cholesky import cholesky
    from gpsat_tpu_torch.ops.panel_chol import factor_panels

    return {"block_chol": factor_blocks, "panel_chol": factor_panels, "cholesky": cholesky}


def drive(phase, core, batch, init, profile_to=None):
    """One path at the full width through the engine: a warm-up call, then
    one timed call with every kernel's launch count set to 0 just before it
    and read just after. Returns (results, launches by kernel)."""
    import torch

    from gpsat_tpu_torch.parallel.engine import make_batched_runner, run_tile_batch
    from gpsat_tpu_torch.utils.flops import gpr_fused_iter_flops, gpr_predict_flops

    runner = make_batched_runner(core, fixed_params=core.default_fixed_params, **RUN_KW)
    t0 = time.perf_counter()
    run_tile_batch(batch, init, runner, core)
    first_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = run_tile_batch(batch, init, runner, core)  # finalize() copies to host: synchronised
    steady_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}

    conv = int(res["converged"].sum())
    it_max = int(res["num_iter"].max())
    flops = B * it_max * gpr_fused_iter_flops(N, D) + B * gpr_predict_flops(N, P, D)
    log(phase, core=core.name, experts_per_s=B / steady_s, steady_s=steady_s, first_call_s=first_s, converged=conv, B=B,
        iters_mean=float(res["num_iter"].mean()), iters_max=it_max, stall_exits=int(res["stalled"].sum()),
        failed_exits=int(res["failed"].sum()), achieved_tflops=flops / steady_s / 1e12,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches)
    check(np.isfinite(res["f_mean"]).all() and np.isfinite(res["f_var"]).all(), f"{phase}: non-finite predictions")
    check(conv >= 0.9 * B, f"{phase}: only {conv}/{B} lanes converged")

    if profile_to:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_tile_batch(batch, init, runner, core)
            traced_s = time.perf_counter() - t0
        events = prof.key_averages()
        # the kernels' own rows only (an aten op's row repeats the time of
        # the kernels it launched); one stream, so kernels do not overlap
        device_s = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA) / 1e6
        own = {e.key: e.self_device_time_total / 1e6 for e in events
               if e.device_type == DeviceType.CUDA and any(k in e.key for k in OWN_KERNELS)}
        table = events.table(sort_by="self_device_time_total", row_limit=25)
        outdir = ROOT / "chiprun_out"
        outdir.mkdir(exist_ok=True)
        (outdir / profile_to).write_text(table)
        print(table, flush=True)
        log("profile", path=phase, traced_s=traced_s, device_busy_s=device_s, device_busy_share=device_s / traced_s,
            own_kernels_device_s=own, own_kernels_share_of_device=sum(own.values()) / device_s if device_s else None)
        check(0.0 < device_s <= traced_s, f"device busy {device_s} s of a {traced_s} s traced call")
    return res, launches, it_max


def phase_main(batch, init, profile: bool):
    from gpsat_tpu_torch.models.functional import make_gpr_core

    res, launches, it_max = drive("main", make_gpr_core(jitter=1e-5), batch, init, "profile.txt" if profile else None)
    # 8 diagonal blocks per factor pair; one pair per L-BFGS value+grad (the
    # initial one plus one per iteration of the slowest lane) and one in predict
    expected = {"block_chol": (it_max + 2) * (N // T), "panel_chol": 0, "cholesky": 0}
    check(launches == expected, f"main path launches {launches}, expected {expected}")
    return res, launches["block_chol"]


def phase_accuracy(batch, init):
    import torch

    from gpsat_tpu_torch.models.functional import make_gpr_core
    from gpsat_tpu_torch.parallel.batching import cast_batch, take_batch
    from gpsat_tpu_torch.parallel.engine import make_batched_runner, run_tile_batch

    idx = np.arange(CPU_TILES)
    sub = take_batch(batch, idx)
    sub_init = {k: v[idx] for k, v in init.items()}
    core = make_gpr_core(jitter=1e-5)
    gpu = run_tile_batch(sub, sub_init, make_batched_runner(core, **RUN_KW), core)
    t0 = time.perf_counter()
    cpu = run_tile_batch(
        cast_batch(sub, np.float64), {k: v.astype(np.float64) for k, v in sub_init.items()},
        make_batched_runner(core, device="cpu", **CPU_F64_KW), core, device="cpu",
    )
    cpu_s = time.perf_counter() - t0
    dmean = float(np.abs(gpu["f_mean"] - cpu["f_mean"]).max())
    dvar = float(np.abs(gpu["f_var"] - cpu["f_var"]).max())
    log("accuracy", tiles=CPU_TILES, max_abs_dmean=dmean, max_abs_dvar=dvar, bound=PRED_BOUND,
        converged_gpu=int(gpu["converged"].sum()), converged_cpu_f64=int(cpu["converged"].sum()), cpu_f64_s=cpu_s,
        torch_threads=torch.get_num_threads())
    check(dmean <= PRED_BOUND and dvar <= PRED_BOUND, f"card vs CPU f64: dmean {dmean}, dvar {dvar}")
    return sub, sub_init, cpu


def phase_f64(sub, sub_init, cpu):
    """Phase 4's tiles in f64 on the card, on the block, panel and cholesky
    routes with phase 4's CPU f64 settings: the kernels take f32 only, so f64
    takes the library arm of each route and launches no kernel. Each route
    is held against phase 4's CPU f64 result."""
    import torch

    from gpsat_tpu_torch.models.functional import make_gpr_core
    from gpsat_tpu_torch.parallel.batching import cast_batch
    from gpsat_tpu_torch.parallel.engine import make_batched_runner, run_tile_batch

    batch64 = cast_batch(sub, np.float64)
    init64 = {k: v.astype(np.float64) for k, v in sub_init.items()}
    for factor in ("block", "panel", "cholesky"):
        core = make_gpr_core(jitter=1e-5, factor=factor)
        runner = make_batched_runner(core, **CPU_F64_KW)
        for fn in counters().values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = run_tile_batch(batch64, init64, runner, core)
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters().items()}
        dmean = float(np.abs(res["f_mean"] - cpu["f_mean"]).max())
        dvar = float(np.abs(res["f_var"] - cpu["f_var"]).max())
        log("f64", factor=factor, tiles=len(sub.X), seconds=seconds, max_abs_dmean=dmean, max_abs_dvar=dvar,
            bound=F64_BOUND, converged=int(res["converged"].sum()), iters_max=int(res["num_iter"].max()),
            launches=launches, dtype=str(res["f_mean"].dtype))
        check(res["f_mean"].dtype == np.float64 and np.isfinite(res["f_mean"]).all() and np.isfinite(res["f_var"]).all(),
              f"f64 on the card, {factor} route: predictions not finite f64")
        check(dmean <= F64_BOUND and dvar <= F64_BOUND, f"f64 card vs CPU, {factor} route: dmean {dmean}, dvar {dvar}")
        check(not any(launches.values()), f"f64 on the {factor} route launched a kernel: {launches}")
    torch.cuda.synchronize()


def phase_panel(batch, init, main_res, profile: bool):
    from gpsat_tpu_torch.models.functional import make_gpr_core
    from gpsat_tpu_torch.ops.panel_chol import T_PANEL

    res, launches, it_max = drive("panel", make_gpr_core(jitter=1e-5, factor="panel"), batch, init,
                                  "profile_panel.txt" if profile else None)
    # 4 diagonal 128-blocks per factor pair, one pair per value+grad; the
    # predict factors once with the full Cholesky kernel and never with kernel 1
    expected = {"block_chol": 0, "panel_chol": (it_max + 1) * (N // T_PANEL), "cholesky": 1}
    check(launches == expected, f"panel path launches {launches}, expected {expected}")
    dmean = float(np.abs(res["f_mean"] - main_res["f_mean"]).max())
    dvar = float(np.abs(res["f_var"] - main_res["f_var"]).max())
    log("panel_vs_block", max_abs_dmean=dmean, max_abs_dvar=dvar, bound=ROUTE_BOUND,
        same_num_iter=int((res["num_iter"] == main_res["num_iter"]).sum()))
    check(dmean <= ROUTE_BOUND and dvar <= ROUTE_BOUND, f"panel vs block route: dmean {dmean}, dvar {dvar}")
    return launches["panel_chol"]


def phase_profiled(batch, init, profile: bool):
    from gpsat_tpu_torch.models.functional import make_gpr_core
    from gpsat_tpu_torch.parallel.batching import cast_batch, take_batch
    from gpsat_tpu_torch.parallel.engine import make_batched_runner, run_tile_batch

    core = make_gpr_core(jitter=1e-5, profile_variance=True)
    res, launches, it_max = drive("profiled", core, batch, init, "profile_profiled.txt" if profile else None)
    # one full Cholesky per value+grad and one in finalize_params; the predict
    # takes the "block" pair: 8 launches of kernel 1
    expected = {"block_chol": N // T, "panel_chol": 0, "cholesky": it_max + 2}
    check(launches == expected, f"profiled path launches {launches}, expected {expected}")

    idx = np.arange(PROFILED_CPU_TILES)
    sub = take_batch(batch, idx)
    sub_init = {k: v[idx].astype(np.float64) for k, v in init.items()}
    t0 = time.perf_counter()
    cpu = run_tile_batch(
        cast_batch(sub, np.float64), sub_init,
        make_batched_runner(core, fixed_params=core.default_fixed_params, linesearch="single_eval",
                            tol_grad=1e-6, tol_f=1e-11, device="cpu"),
        core, device="cpu",
    )
    cpu_s = time.perf_counter() - t0
    collapsed_all = int((res["lengthscales"].max(-1) < COLLAPSED_LS).sum())
    keep = ~((res["lengthscales"][idx].max(-1) < COLLAPSED_LS) | (cpu["lengthscales"].max(-1) < COLLAPSED_LS))
    check(keep.sum() >= MIN_COMPARED_SHARE * len(idx), f"only {int(keep.sum())}/{len(idx)} tiles collapsed on neither side")
    dmean = float(np.abs(res["f_mean"][idx] - cpu["f_mean"])[keep].max())
    dvar = float(np.abs(res["f_var"][idx] - cpu["f_var"])[keep].max())
    log("profiled_accuracy", tiles=len(idx), compared=int(keep.sum()), collapsed_lanes_of_B=collapsed_all,
        max_abs_dmean=dmean, max_abs_dvar=dvar, bound=PRED_BOUND, converged_cpu_f64=int(cpu["converged"].sum()),
        cpu_f64_s=cpu_s)
    check(dmean <= PRED_BOUND and dvar <= PRED_BOUND, f"profiled, card vs CPU f64: dmean {dmean}, dvar {dvar}")
    return launches["cholesky"]


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from concurrent.futures import ThreadPoolExecutor

    from gpsat_tpu_torch.ops import _build
    from gpsat_tpu_torch.ops import block_chol as BC
    from gpsat_tpu_torch.ops import cholesky as CH
    from gpsat_tpu_torch.ops import panel_chol as PC

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("device", card=card, torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, all started together
        libs = list(pool.map(_build.build_library, KERNELS))
    log("build", seconds=time.perf_counter() - t0, libraries=[str(lib.relative_to(ROOT)) for lib in libs])
    for lib in libs:
        print(Path(str(lib) + ".log").read_text().strip(), flush=True)

    profile = "--profile" in argv
    entries = [phase_kernel(BC), phase_kernel_panel(PC), phase_kernel_cholesky(CH, profile)]
    if "--kernels" in argv:
        return 0
    batch, init = bench_workload()
    main_res, entries[0]["launches"] = phase_main(batch, init, profile)
    phase_f64(*phase_accuracy(batch, init))
    entries[1]["launches"] = phase_panel(batch, init, main_res, profile)
    entries[2]["launches"] = phase_profiled(batch, init, profile)

    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
