"""Time kernel 1 (factor_blocks: L and W = L^-1 of [512, 64, 64] f32 blocks) on
one NVIDIA card, in turns with an earlier tree's version of the same kernel
and with the library pair.

    python3 bench_block_chol.py [--parent DIR] [--rounds 2] [--ablate]

DIR is an unpacked earlier tree (for example `git archive <commit>` into a
directory that .gitignore lists). Libraries are built from
`<tree>/gpsat_tpu_torch/csrc/block_chol.cu`, each with its own tree's
headers: "change" (this tree) and, with DIR, "parent".

1. Each kernel's output on chip_smoke.py's kernel-1 input is held against
   `factor_blocks_reference` with chip_smoke.py's bounds (1e-4 on L, W and
   L W - I); the parent's L and W against the change's bit for bit
   (`torch.equal`; reported, not required).
2. The variants are timed in the order parent, change, library, library,
   change, parent (repeated --rounds times) with chip_smoke.py's CUDA-event
   timers: per call (one call between an event pair, median of 20) and back
   to back (20 calls between one event pair, divided by 20, median of 5);
   and L2-cold (a 256 MB write before each call, then one call between an
   event pair that the write's kernel keeps the host ahead of: the device
   time of one call with K out of L2, median of 20).
   "library" is `cholesky_ex` + `solve_triangular`.
3. The factor pair of the main path, `ops/linalg.chol_winv_batched`, at
   [512, 512, 512] f32 with each tree's kernel as its diagonal-block factor:
   max |dL| and |dW| against the same factor pair on the plain version, and its
   time per call in turns parent, change, change, parent.

With --ablate, it also builds this tree's kernel with parts cut out
(timing only: these outputs are wrong, and no check is made) and times each
per call and back to back, to show where the time goes: "no_second_diag"
(the diagonal step of block (1,1)), "no_diag" (both diagonal steps),
"no_products" (the four tile products), "io_only" (both cut: the loads, the
stores and the barriers). Each cut is a text edit of block_chol.cu that must
match exactly once.

The kernels are called through their C entry, so the package's launch
counters do not move. Prints one JSON line per measurement and writes them
all to chiprun_out/bench_block_chol.json. Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
B, T, N = 512, 64, 512
FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2
_DIAG = "if (tid < 32) f128::diag_factor_inverse</*kClamp=*/false, LDA, LDW>"
CUT_DIAG = [(_DIAG + "(A, W00, buf, tid);", ""), (_DIAG + "(A11, W11, buf, tid);", "")]
CUT_PRODUCTS = [(call, "") for call in (
    "f128::tile_abt<false>(acc, A10, LDA, W00, LDW, r0, c0);",
    "f128::tile_abt<true>(acc, A10, LDA, A10, LDA, r0, c0);",
    "f128::tile_ab<false>(acc, W11, LDW, A10, LDA, r0, c0);",
    "f128::tile_ab<true>(acc, W10, LDW, W00, LDW, r0, c0);",
)]
ABLATIONS = {
    "no_second_diag": CUT_DIAG[1:],
    "no_diag": CUT_DIAG,
    "no_products": CUT_PRODUCTS,
    "io_only": CUT_DIAG + CUT_PRODUCTS,
}


def cold_ms(fn, reps=20):
    """Median of per-call CUDA-event times (ms), each call after a write of
    FLUSH_BYTES that evicts the L2."""
    import torch

    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_block_chol: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench_panel_chol import build
    from chip_smoke import HBM_BYTES_PER_S, back_to_back_ms, factor_bytes, spd_batch, time_ms
    from gpsat_tpu_torch.ops import block_chol as BC
    from gpsat_tpu_torch.ops import linalg as LA

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    trees = {"change": ROOT}
    if args.parent is not None:
        trees["parent"] = args.parent.resolve()
    jobs = {}
    for name, tree in trees.items():
        csrc = tree / "gpsat_tpu_torch" / "csrc"
        jobs[f"block_chol_{name}"] = (csrc / "block_chol.cu", (csrc / "block_chol.cu").read_text(), csrc)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = dict(zip(trees, pool.map(lambda kv: build(kv[0], *kv[1]), jobs.items())))
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)

    K = spd_batch(B, T, seed=0)
    Lr, Wr = BC.factor_blocks_reference(K)
    eye = torch.eye(T, device=K.device)
    stream = torch.cuda.current_stream().cuda_stream

    factors, fns, outs, records = {}, {}, {}, []
    for name, path in paths.items():
        entry = ctypes.CDLL(str(path)).gpsat_cholinv64_f32
        entry.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        entry.restype = ctypes.c_int

        def factor(Kd, entry=entry):
            L, W = torch.empty_like(Kd), torch.empty_like(Kd)
            err = entry(Kd.data_ptr(), L.data_ptr(), W.data_ptr(), Kd.shape[0], stream)
            if err != 0:
                raise RuntimeError(f"launch failed: cudaError {err}")
            return L, W

        L, W = factor(K)
        torch.cuda.synchronize()
        err_L, err_W = float((L - Lr).abs().max()), float((W - Wr).abs().max())
        err_LW = float((torch.matmul(L, W) - eye).abs().max())
        ok = max(err_L, err_W, err_LW) <= 1e-4
        rec = {"check": name, "max_abs_err_L": err_L, "max_abs_err_W": err_W, "max_abs_LW_minus_I": err_LW, "ok": ok}
        print(json.dumps(rec), flush=True)
        records.append(rec)
        if not ok:
            raise RuntimeError(f"{name} disagrees with the plain version: {rec}")
        factors[name] = factor
        fns[name] = lambda factor=factor: factor(K)
        outs[name] = (L, W)

    if "parent" in outs:
        same_L = torch.equal(outs["parent"][0], outs["change"][0])
        same_W = torch.equal(outs["parent"][1], outs["change"][1])
        rec = {"bit_identical_to_parent": same_L and same_W, "L": same_L, "W": same_W,
               "max_abs_dL_to_parent": float((outs["parent"][0] - outs["change"][0]).abs().max()),
               "max_abs_dW_to_parent": float((outs["parent"][1] - outs["change"][1]).abs().max())}
        print(json.dumps(rec), flush=True)
        records.append(rec)

    def library():
        Lc, _ = torch.linalg.cholesky_ex(K)
        return torch.linalg.solve_triangular(Lc, eye.expand(B, T, T), upper=False)

    fns["library"] = library
    first = [n for n in ("parent", "change") if n in fns] + ["library"]
    order = (first + first[::-1]) * args.rounds
    for turn, name in enumerate(order):
        fn = fns[name]
        rec = {"turn": turn, "variant": name, "shape": [B, T, T], "ms": time_ms(fn),
               "ms_back_to_back": back_to_back_ms(fn), "ms_l2_cold": cold_ms(fn)}
        print(json.dumps(rec), flush=True)
        records.append(rec)

    # the main path's factor pair on each tree's kernel, against the plain version
    KN = spd_batch(B, N, seed=2)

    def factor_pair(factor_diag):
        L, Wdiags = LA._blocked_cholesky(KN, T, factor_diag)
        return L, LA.tri_inv_from_diag(L, torch.stack(Wdiags, dim=1), T)

    LN, WN = factor_pair(BC.factor_blocks_reference)
    for name, factor in factors.items():
        L, W = factor_pair(factor)
        torch.cuda.synchronize()
        rec = {"pair_check": name, "shape": [B, N, N], "max_abs_dL": float((L - LN).abs().max()),
               "max_abs_dW": float((W - WN).abs().max())}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    del LN, WN
    names = [n for n in ("parent", "change") if n in factors]
    for turn, name in enumerate((names + names[::-1]) * args.rounds):
        rec = {"pair_turn": turn, "variant": name, "shape": [B, N, N],
               "ms": time_ms(lambda factor=factors[name]: factor_pair(factor), reps=10, warm=2)}
        print(json.dumps(rec), flush=True)
        records.append(rec)

    ablations = {}
    if args.ablate:
        from bench_cholesky import ablated

        here = ROOT / "gpsat_tpu_torch" / "csrc"
        text = (here / "block_chol.cu").read_text()
        jobs = {f"block_chol_{name}": (here / "block_chol.cu", ablated(text, edits), here)
                for name, edits in ABLATIONS.items()}
        with ThreadPoolExecutor(len(jobs)) as pool:
            libs = dict(zip(ABLATIONS, pool.map(lambda kv: build(kv[0], *kv[1]), jobs.items())))
        for name, path in libs.items():
            entry = ctypes.CDLL(str(path)).gpsat_cholinv64_f32
            entry.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
            entry.restype = ctypes.c_int
            L, W = torch.empty_like(K), torch.empty_like(K)

            def call(entry=entry, L=L, W=W):
                err = entry(K.data_ptr(), L.data_ptr(), W.data_ptr(), B, stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: cudaError {err}")

            ablations[name] = {"ms": time_ms(call), "ms_back_to_back": back_to_back_ms(call)}
            print(json.dumps({"ablation": name, **ablations[name]}), flush=True)

    summary = {"card": card, "bound_ms": factor_bytes(B, T, 2) / HBM_BYTES_PER_S * 1e3, "ablations": ablations}
    for name in fns:
        rows = [r for r in records if r.get("variant") == name and "turn" in r]
        summary[name] = {k: float(np.median([r[k] for r in rows])) for k in ("ms", "ms_back_to_back", "ms_l2_cold")}
        drows = [r["ms"] for r in records if r.get("variant") == name and "pair_turn" in r]
        if drows:
            summary[name]["chol_winv_batched_ms"] = float(np.median(drows))
    print(json.dumps({"summary": summary}), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "bench_block_chol.json").write_text(json.dumps({"summary": summary, "records": records}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
