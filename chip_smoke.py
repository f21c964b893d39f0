"""Smoke run of the PyTorch/CUDA port (gpsat_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # one card; exits non-zero on any failure
    python3 chip_smoke.py --profile    # also write a torch.profiler table of one
                                       # main-path run to chiprun_out/profile.txt

Phases (each prints on its own lines; any failure raises):

1. build     compile gpsat_tpu_torch/csrc/block_chol.cu with nvcc for sm_90a
2. kernel    the CUDA factor_blocks against its plain PyTorch version on the
             card at the main path's [512, 64, 64] f32, a non-SPD block's NaN,
             and CUDA-event times of the kernel, the plain version and one
             library call (cholesky_ex + solve_triangular) as the yardstick
3. main      bench.py's workload (B=512, N=512, P=64, D=2, Matern32, f32,
             single-eval L-BFGS) through the port's engine: a warm-up call,
             then one timed call with the kernel launch counter read around it
4. accuracy  the first 16 tiles, f32 on the card against f64 on the CPU

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
B, N, P, D = 512, 512, 64, 2
T = 64
CPU_TILES = 16
# f32 card vs f64 CPU on predictions: raw f32 optima sit ~3e-3 from f64 gold
# (flat optima; the repo's accuracy logs), so 1e-2 catches a wrong path
# without failing on f32 hyperparameter drift
PRED_BOUND = 1e-2


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


def phase_kernel(BC):
    import torch

    rng = np.random.default_rng(0)
    A = rng.standard_normal((B, T, T)).astype(np.float32)
    K = torch.from_numpy(A @ np.swapaxes(A, 1, 2) + T * np.eye(T, dtype=np.float32)).cuda()
    L, W = BC.factor_blocks(K)
    torch.cuda.synchronize()
    Lr, Wr = BC.factor_blocks_reference(K)
    err_L = float((L - Lr).abs().max())
    err_W = float((W - Wr).abs().max())
    eye = torch.eye(T, device=K.device)
    err_LW = float((torch.matmul(L, W) - eye).abs().max())
    # f32, 64 dependent steps, FMA-contracted in the kernel and not in the
    # plain version; L entries are O(10): 1e-4 absolute
    check(err_L <= 1e-4 and err_W <= 1e-4, f"kernel vs plain version: |dL| {err_L}, |dW| {err_W}")
    check(err_LW <= 1e-4, f"max |LW - I| = {err_LW}")
    check(float(torch.triu(L, 1).abs().max()) == 0.0 and float(torch.triu(W, 1).abs().max()) == 0.0,
          "strict upper triangles not zero")
    bad = torch.stack([eye, -eye]).contiguous()
    Ln, Wn = BC.factor_blocks(bad)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(Ln[0]).all()) and bool(torch.isnan(Ln[1]).any()) and bool(torch.isnan(Wn[1]).any()),
          "a -I block must give NaN in L and W, an I block beside it finite values")

    ms = time_ms(lambda: BC.factor_blocks(K))
    plain_ms = time_ms(lambda: BC.factor_blocks_reference(K))

    def library():
        Lc, _ = torch.linalg.cholesky_ex(K)
        return torch.linalg.solve_triangular(Lc, eye.expand(B, T, T), upper=False)

    library_ms = time_ms(library)
    # least work: read K once, write L and W once; Cholesky T^3/3 + inverse T^3/3 flops
    bytes_ms = 3 * B * T * T * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = B * (2.0 / 3.0) * T**3 / F32_FLOPS_PER_S * 1e3
    entry = {
        "name": "block_chol.factor_blocks",
        "route": "cuda",
        "source": "gpsat_tpu_torch/csrc/block_chol.cu",
        "replaces": "gpsat_tpu/ops/pallas/block_chol.py:50",
        "launches": None,
        "max_abs_err": max(err_L, err_W),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }
    log("kernel", shape=[B, T, T], err_L=err_L, err_W=err_W, max_abs_LW_minus_I=err_LW, nan_case="ok",
        ms=ms, plain_ms=plain_ms, library_ms=library_ms, bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms)
    return entry


def phase_main(BC, profile: bool):
    import torch

    from gpsat_tpu_torch.models.functional import make_gpr_core
    from gpsat_tpu_torch.parallel.engine import make_batched_runner, run_tile_batch
    from gpsat_tpu_torch.utils.flops import gpr_fused_iter_flops, gpr_predict_flops

    batch, init = bench_workload()
    core = make_gpr_core(jitter=1e-5)
    runner = make_batched_runner(core, max_iter=100, linesearch="single_eval", tol_grad=1e-3, tol_f=1e-6)

    t0 = time.perf_counter()
    run_tile_batch(batch, init, runner, core)
    first_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    BC.factor_blocks.launches = 0
    t0 = time.perf_counter()
    res = run_tile_batch(batch, init, runner, core)  # finalize() copies to host: synchronised
    steady_s = time.perf_counter() - t0
    launches = BC.factor_blocks.launches

    conv = int(res["converged"].sum())
    it_max = int(res["num_iter"].max())
    flops = B * it_max * gpr_fused_iter_flops(N, D) + B * gpr_predict_flops(N, P, D)
    out = {
        "experts_per_s": B / steady_s,
        "steady_s": steady_s,
        "first_call_s": first_s,
        "converged": conv,
        "B": B,
        "iters_mean": float(res["num_iter"].mean()),
        "iters_max": it_max,
        "stall_exits": int(res["stalled"].sum()),
        "failed_exits": int(res["failed"].sum()),
        "achieved_tflops": flops / steady_s / 1e12,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "factor_blocks_launches": launches,
        # 8 diagonal blocks per factor pair; one pair per L-BFGS value+grad
        # (the initial one plus one per iteration of the slowest lane) and
        # one in predict
        "launches_expected": (it_max + 2) * (N // T),
    }
    log("main", **out)
    check(launches > 0, "the main path launched no block_chol kernel")
    check(np.isfinite(res["f_mean"]).all() and np.isfinite(res["f_var"]).all(), "non-finite predictions")
    check(conv >= 0.9 * B, f"only {conv}/{B} lanes converged")

    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_tile_batch(batch, init, runner, core)
            traced_s = time.perf_counter() - t0
        from torch.autograd import DeviceType

        events = prof.key_averages()
        # the kernels' own rows only (an aten op's row repeats the time of
        # the kernels it launched); one stream, so kernels do not overlap
        device_s = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA) / 1e6
        table = events.table(sort_by="self_device_time_total", row_limit=25)
        outdir = ROOT / "chiprun_out"
        outdir.mkdir(exist_ok=True)
        (outdir / "profile.txt").write_text(table)
        print(table, flush=True)
        log("profile", traced_s=traced_s, device_busy_s=device_s, device_busy_share=device_s / traced_s)
        check(0.0 < device_s <= traced_s, f"device busy {device_s} s of a {traced_s} s traced call")
    return batch, init, launches


def phase_accuracy(batch, init):
    import torch

    from gpsat_tpu_torch.models.functional import make_gpr_core
    from gpsat_tpu_torch.parallel.batching import cast_batch, take_batch
    from gpsat_tpu_torch.parallel.engine import make_batched_runner, run_tile_batch

    idx = np.arange(CPU_TILES)
    sub = take_batch(batch, idx)
    sub_init = {k: v[idx] for k, v in init.items()}
    core = make_gpr_core(jitter=1e-5)
    gpu = run_tile_batch(
        sub, sub_init, make_batched_runner(core, max_iter=100, linesearch="single_eval", tol_grad=1e-3, tol_f=1e-6),
        core,
    )
    t0 = time.perf_counter()
    cpu = run_tile_batch(
        cast_batch(sub, np.float64), {k: v.astype(np.float64) for k, v in sub_init.items()},
        make_batched_runner(core, linesearch="single_eval", tol_grad=1e-6, tol_f=1e-11, device="cpu"),
        core, device="cpu",
    )
    cpu_s = time.perf_counter() - t0
    dmean = float(np.abs(gpu["f_mean"] - cpu["f_mean"]).max())
    dvar = float(np.abs(gpu["f_var"] - cpu["f_var"]).max())
    log("accuracy", tiles=CPU_TILES, max_abs_dmean=dmean, max_abs_dvar=dvar, bound=PRED_BOUND,
        converged_gpu=int(gpu["converged"].sum()), converged_cpu_f64=int(cpu["converged"].sum()), cpu_f64_s=cpu_s,
        torch_threads=torch.get_num_threads())
    check(dmean <= PRED_BOUND and dvar <= PRED_BOUND, f"card vs CPU f64: dmean {dmean}, dvar {dvar}")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from gpsat_tpu_torch.ops import block_chol as BC

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("device", card=card, torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    lib = BC.build_library()
    BC._load_lib()
    log("build", seconds=time.perf_counter() - t0, library=str(lib.relative_to(ROOT)))
    nvcc_log = Path(str(lib) + ".log")
    if nvcc_log.exists():
        print(nvcc_log.read_text().strip(), flush=True)

    entry = phase_kernel(BC)
    batch, init, launches = phase_main(BC, profile="--profile" in argv)
    entry["launches"] = launches
    phase_accuracy(batch, init)

    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
