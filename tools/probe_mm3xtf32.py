"""Probe the 3xTF32 product (kernel 4, csrc/mm3xtf32.cu) on one card: its
error and time against the true-f32 torch.matmul, and what it does to the
SGPR bound's f32 evaluation.

    python tools/probe_mm3xtf32.py [--out FILE]

Prints one JSON line per part and, with --out, writes them all to FILE.
Needs a CUDA card; imports nothing of JAX.

- shapes: the SGPR chunk loop's four product shapes at phase 9 (b)'s
  geometry (B = 8, M = 500, chunks of 4,096): W Kuf, A A^T, dW = dA Kuf^T,
  dKuf = W^T dA, on standard normal operands: the kernel's error against
  its plain version and the f64 product (relative to max (|A||B|)), and
  CUDA-event times of the kernel, the plain version and torch.matmul.
- operands: six operand kinds (independent normal at K = 500 and 4,096,
  A A^T of one normal or one uniform [0, 1] operand at K = 4,096 and of a
  normal one at K = 500, uniform [0, 1] operands at K = 500), the errors
  of the kernel, the plain version and torch.matmul against f64.
- bound: phase 9 (b)'s first 4 tiles (chip_smoke.make_large_tiles) fitted
  in f32 on the card; at that optimum the bound and its lengthscale
  gradient evaluated in f32 at "highest" and at "high", each against the
  f64 values there (the bound in nats, the gradient's largest absolute
  error).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gpsat_tpu_torch.ops import mm3xtf32 as MM  # noqa: E402


def _rel(C, exact, scale):
    return float((C.double() - exact).abs().max()) / scale


def _errors(a, b, ta, tb):
    opa, opb = MM._op(a, ta), MM._op(b, tb)
    exact = torch.matmul(opa.double(), opb.double())
    scale = float(torch.matmul(opa.abs().double(), opb.abs().double()).max())
    kernel = MM.mm3xtf32(a, b, ta, tb)
    plain = MM.mm3xtf32_reference(a, b, ta, tb)
    torch.cuda.synchronize()
    return {"kernel_rel": _rel(kernel, exact, scale), "plain_rel": _rel(plain, exact, scale),
            "matmul_f32_rel": _rel(torch.matmul(opa, opb), exact, scale),
            "kernel_vs_plain_rel": float((kernel - plain).abs().max()) / scale}


def shapes(dev):
    rng = np.random.default_rng(0)
    B, M, C = cs.SGPR_CHUNKED[0], cs.SGPR_M, cs.MM_CHUNK
    out = {}
    for name, (rows, cols, K), ta, tb in (("w_kuf", (M, C, M), False, False), ("a_at", (M, M, C), False, True),
                                          ("d_w", (M, M, C), False, True), ("d_kuf", (M, C, M), True, False)):
        a = torch.from_numpy(rng.standard_normal((B, K, rows) if ta else (B, rows, K)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.standard_normal((B, cols, K) if tb else (B, K, cols)).astype(np.float32)).to(dev)
        row = _errors(a, b, ta, tb)
        row.update(shape=[B, rows, cols, K], bound=cs.mm_bound(K),
                   ms=cs.time_ms(lambda: MM.mm3xtf32(a, b, ta, tb)),
                   ms_back_to_back=cs.back_to_back_ms(lambda: MM.mm3xtf32(a, b, ta, tb)),
                   plain_ms=cs.time_ms(lambda: MM.mm3xtf32_reference(a, b, ta, tb), reps=5),
                   matmul_ms=cs.time_ms(lambda: torch.matmul(MM._op(a, ta), MM._op(b, tb))))
        row["tflops_issued"] = 3 * 2.0 * B * rows * cols * K / row["ms"] / 1e9
        out[name] = row
    return out


def operands(dev):
    rng = np.random.default_rng(1)

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    A, P, A5 = (t(rng.standard_normal((8, 500, 4096))), t(rng.uniform(0, 1, (8, 500, 4096))),
                t(rng.standard_normal((8, 500, 500))))
    cases = {
        "normal_K500": (t(rng.standard_normal((8, 500, 500))), t(rng.standard_normal((8, 500, 4096))), False),
        "normal_K4096": (t(rng.standard_normal((8, 500, 4096))), t(rng.standard_normal((8, 500, 4096))), True),
        "normal_aat_K4096": (A, A, True),
        "uniform_aat_K4096": (P, P, True),
        "normal_aat_K500": (A5, A5, True),
        "uniform_K500": (t(rng.uniform(0, 1, (8, 500, 500))), t(rng.uniform(0, 1, (8, 500, 4096))), False),
    }
    return {name: {**_errors(a, b, False, tb), "bound": cs.mm_bound(b.shape[2] if tb else b.shape[1])}
            for name, (a, b, tb) in cases.items()}


def bound(dev):
    from gpsat_tpu_torch.models import sgpr as SG
    from gpsat_tpu_torch.parallel.batching import take_batch
    from gpsat_tpu_torch.parallel.engine import make_batched_runner, run_tile_batch

    # the f32 fit's optimum: the f32 bound is evaluated where an f32 fit
    # stands (at the f64 fit's optimum an f32 factor of Kuu, condition ~1e7
    # at jitter 1e-6, can fail)
    batch = take_batch(cs.make_large_tiles(*cs.SGPR_CHUNKED, cs.SGPR_P, cs.D, np.float32),
                       np.arange(cs.SGPR_F64_TILES))
    core = cs.sgpr_core()
    res = run_tile_batch(batch, {"smart_init": True},
                         make_batched_runner(core, fixed_params=core.default_fixed_params, **cs.SGPR_RUN_KW), core)
    data = {"X": batch.X, "y": batch.y, "mask": batch.mask}
    out = {"tiles": len(batch.X), "f32_iters": res["num_iter"].tolist()}
    values = {}
    for tag, dtype, level in (("f64", torch.float64, "highest"), ("f32_highest", torch.float32, "highest"),
                              ("f32_high", torch.float32, "high")):
        params = {k: torch.as_tensor(np.asarray(res[k]), dtype=dtype, device=dev).requires_grad_(k == "lengthscales")
                  for k in ("lengthscales", "kernel_variance", "likelihood_variance", "inducing_points")}
        d = {k: torch.as_tensor(v, dtype=dtype, device=dev) for k, v in data.items()}
        e = SG.elbo(params, d, kernel="Matern32", chunk_size="auto", accum_precision=level)
        (g,) = torch.autograd.grad(e.sum(), [params["lengthscales"]])
        values[tag] = (e.detach().double().cpu(), g.double().cpu())
    e64, g64 = values["f64"]
    out["bound_f64"] = e64.tolist()
    for tag in ("f32_highest", "f32_high"):
        e, g = values[tag]
        # near the optimum the gradient is small: the f32 gradient's absolute
        # error, in nats per unit lengthscale
        out[tag] = {"bound_minus_f64_nats": (e - e64).tolist(), "grad_abs_err": float((g - g64).abs().max())}
    out["grad_f64_max_abs"] = float(g64.abs().max())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_mm3xtf32: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    result = {"card": card, "torch": torch.__version__}
    for name, fn in (("shapes", shapes), ("operands", operands), ("bound", bound)):
        result[name] = fn(dev)
        print(json.dumps({name: result[name]}), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
