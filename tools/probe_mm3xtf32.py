"""Probe the 3xTF32 product (kernel 4, csrc/mm3xtf32.cu) on one card: its
error and time against the true-f32 torch.matmul, what it does to the SGPR
bound's f32 evaluation, and, with --parent, an A/B against an earlier
tree's kernel.

    python tools/probe_mm3xtf32.py [--parent DIR] [--ablate] [--parts shapes operands bound] [--rounds 2]
                                   [--out FILE]

Prints one JSON line per part and, with --out, writes them all to FILE.
Needs a CUDA card; imports nothing of JAX.

- shapes: the SGPR chunk loop's product shapes at phase 9 (b)'s geometry
  (B = 8, M = 500, chunks of 4,096): W Kuf (W the [8, 500, 500] view of an
  [8, 512, 512] buffer, as the chunk loop passes it), A A^T, dW = dA
  Kuf^T, dKuf = W^T dA, on standard normal operands: the kernel's error
  against its plain version and the f64 product (relative to max (|A||B|)),
  and CUDA-event times of the kernel (per call and back to back), the plain
  version and torch.matmul. With --parent DIR (an earlier tree unpacked
  with `git archive`, e.g. into _archive/parent), DIR's
  gpsat_tpu_torch/csrc/mm3xtf32.cu is built beside this tree's and called
  through the same C entry, gpsat_mm3xtf32_f32; at each shape the parent,
  this tree's kernel (through ops.mm3xtf32, as the main path calls it) and
  torch.matmul are timed in turns (parent, change, library, library,
  change, parent; --rounds times), per call and back to back, and both
  kernels' errors against f64 are printed. --ablate adds, back to back,
  timing-only builds of this tree's kernel with the split of B, the
  fragment loads of A, the wgmmas, the copies of the main loop or the
  proxy fence cut out, or all but the wgmmas (their products are wrong),
  and a variant that emits the split of B after a step's 12 wgmmas, not
  between them.
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


# timing-only builds of this tree's kernel with one part cut out (--ablate):
# their products are wrong, only their times mean something
_EMIT = "            if (more) split_emit(b_next, b_next + TILE, bx, b_at[s], s, finite);\n"
_SPLIT = [(_EMIT, ""), ("            split_gather<!kTB>(r_next + TILE, bx, b_at);\n            finite = all_finite(bx);\n",
                        "")]  # the split of B, but for step 0's
_FRAGMENTS = ("        if (more) load_fragments<kTA>(x, r_next, wg);\n", "")  # A's fragment loads, but for step 0's
_MMA = ("""            wgmma_m64n128k8_tf32_rs(part, lo[f], lo[f + 1], lo[f + 2], lo[f + 3], sw128_desc(b_hi + o), s > 0);
            wgmma_m64n128k8_tf32_rs(part, hi[f], hi[f + 1], hi[f + 2], hi[f + 3], sw128_desc(b_lo + o), 1);
            wgmma_m64n128k8_tf32_rs(part, hi[f], hi[f + 1], hi[f + 2], hi[f + 3], sw128_desc(b_hi + o), 1);
""", "")
_LOADS = [("        if (k + STAGES - 1 < steps) load_step(k + STAGES - 1);\n", "")]  # the main loop's copies
_FENCE = ("        fence_proxy_async();  // step k + 1's split B, for its wgmmas\n", "")
# the split of B emitted after the step's 12 wgmmas, not between them (a
# variant: its products are right)
_AFTER = [(_EMIT, ""), ("        wgmma_commit_group();", "        wgmma_commit_group();\n"
                        "        for (int s = 0; more && s < BK / 8; ++s) split_emit(b_next, b_next + TILE, bx, b_at[s], s, "
                        "finite);")]
ABLATIONS = {"no_split": _SPLIT, "no_fragments": [_FRAGMENTS], "no_mma": [_MMA], "no_loads": _LOADS,
             "mma_only": _SPLIT + [_FRAGMENTS] + _LOADS, "no_fence": [_FENCE], "emit_after_wgmmas": _AFTER}


def entry_kernel(name: str, source: Path, text: str):
    """A build of ``text`` (a version of ``source``) called through its C
    entry gpsat_mm3xtf32_f32 (the ABI every version shares), as a function
    like ops.mm3xtf32.mm3xtf32."""
    import ctypes

    from bench_panel_chol import build

    entry = ctypes.CDLL(str(build(name, source, text, source.parent))).gpsat_mm3xtf32_f32
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    entry.argtypes = [vp, ll, ll, i, vp, ll, ll, i, vp, i, i, i, i, vp]
    entry.restype = ctypes.c_int

    def mm(a, b, ta=False, tb=False):
        M, K = (a.shape[2], a.shape[1]) if ta else (a.shape[1], a.shape[2])
        N = b.shape[1] if tb else b.shape[2]
        C = torch.empty((a.shape[0], M, N), dtype=torch.float32, device=a.device)
        err = entry(a.data_ptr(), a.stride(1), a.stride(0), int(ta), b.data_ptr(), b.stride(1), b.stride(0), int(tb),
                    C.data_ptr(), a.shape[0], M, N, K, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} failed: cudaError {err}")
        return C

    return mm


def ablated_kernels():
    """The ablated builds, compiled side by side (one nvcc each)."""
    from concurrent.futures import ThreadPoolExecutor

    source = ROOT / "gpsat_tpu_torch" / "csrc" / "mm3xtf32.cu"
    text = source.read_text()
    versions = {}
    for name, cuts in ABLATIONS.items():
        version = text
        for old, new in cuts:
            if old not in version:
                raise RuntimeError(f"--ablate {name}: {old!r} is not in {source}")
            version = version.replace(old, new)
        versions[name] = version
    with ThreadPoolExecutor(len(versions)) as pool:
        built = pool.map(lambda kv: entry_kernel(f"mm3xtf32_{kv[0]}", source, kv[1]), versions.items())
        return dict(zip(versions, built))


def parent_kernel(tree: Path):
    """An earlier tree's kernel, built from DIR/gpsat_tpu_torch/csrc/mm3xtf32.cu."""
    source = tree / "gpsat_tpu_torch" / "csrc" / "mm3xtf32.cu"
    return entry_kernel("mm3xtf32_parent", source, source.read_text())


def shapes(dev, parent=None, rounds=2, ablated=None):
    rng = np.random.default_rng(0)
    B, M, C = cs.SGPR_CHUNKED[0], cs.SGPR_M, cs.MM_CHUNK
    out = {}
    for name, (rows, cols, K), ta, tb in (("w_kuf", (M, C, M), False, False), ("a_at", (M, M, C), False, True),
                                          ("d_w", (M, M, C), False, True), ("d_kuf", (M, C, M), True, False)):
        if name in ("w_kuf", "d_kuf"):  # W: the pair's [B, 500, 500] view of a [B, 512, 512] buffer
            pair = torch.from_numpy(rng.standard_normal((B, 512, 512)).astype(np.float32)).to(dev)
            a = pair[:, :M, :M]
        else:
            a = torch.from_numpy(rng.standard_normal((B, rows, K)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.standard_normal((B, cols, K) if tb else (B, K, cols)).astype(np.float32)).to(dev)
        row = _errors(a, b, ta, tb)
        fns = {"change": lambda: MM.mm3xtf32(a, b, ta, tb),
               "library": lambda: torch.matmul(MM._op(a, ta), MM._op(b, tb))}
        if parent is not None:
            exact = torch.matmul(MM._op(a, ta).double(), MM._op(b, tb).double())
            scale = float(torch.matmul(MM._op(a, ta).abs().double(), MM._op(b, tb).abs().double()).max())
            C_parent = parent(a, b, ta, tb)
            torch.cuda.synchronize()
            row["parent_kernel_rel"] = _rel(C_parent, exact, scale)
            fns["parent"] = lambda: parent(a, b, ta, tb)
            order = ["parent", "change", "library", "library", "change", "parent"] * rounds
        else:
            order = ["change", "library", "library", "change"] * rounds
        turns = {k: {"ms": [], "ms_back_to_back": []} for k in fns}
        for k in order:
            turns[k]["ms"].append(cs.time_ms(fns[k]))
            turns[k]["ms_back_to_back"].append(cs.back_to_back_ms(fns[k]))
        row.update(shape=[B, rows, cols, K], transpose=[ta, tb], bound=cs.mm_bound(K),
                   ms=float(np.median(turns["change"]["ms"])),
                   ms_back_to_back=float(np.median(turns["change"]["ms_back_to_back"])),
                   plain_ms=cs.time_ms(lambda: MM.mm3xtf32_reference(a, b, ta, tb), reps=5),
                   matmul_ms=float(np.median(turns["library"]["ms"])),
                   matmul_ms_back_to_back=float(np.median(turns["library"]["ms_back_to_back"])), turns=turns)
        for cut, fn in (ablated or {}).items():
            row[f"{cut}_ms_back_to_back"] = cs.back_to_back_ms(lambda: fn(a, b, ta, tb))
        if parent is not None:
            row.update(parent_ms=float(np.median(turns["parent"]["ms"])),
                       parent_ms_back_to_back=float(np.median(turns["parent"]["ms_back_to_back"])))
        flops = 3 * 2.0 * B * rows * cols * K
        nbytes = 4 * (B * rows * K + (0 if name == "a_at" else B * K * cols) + B * rows * cols)
        row["bound_ms"] = max(flops / cs.TF32_FLOPS_PER_S, nbytes / cs.HBM_BYTES_PER_S) * 1e3
        row["tflops_issued"] = flops / row["ms_back_to_back"] / 1e9
        row["share_of_bound_back_to_back"] = row["bound_ms"] / row["ms_back_to_back"]
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
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--parts", nargs="+", choices=("shapes", "operands", "bound"),
                    default=["shapes", "operands", "bound"])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_mm3xtf32: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    result = {"card": card, "torch": torch.__version__}
    print(json.dumps(result), flush=True)
    parent = parent_kernel(args.parent.resolve()) if args.parent is not None else None
    ablated = ablated_kernels() if args.ablate else None
    parts = {"shapes": lambda: shapes(dev, parent, args.rounds, ablated), "operands": lambda: operands(dev),
             "bound": lambda: bound(dev)}
    for name in args.parts:
        result[name] = parts[name]()
        print(json.dumps({name: result[name]}), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
