"""Time kernel 3 (cholesky: L of [512, 512, 512] f32) on one NVIDIA card, in
turns with an earlier tree's version of the same kernel and with
`torch.linalg.cholesky_ex`.

    python3 bench_cholesky.py [--parent DIR] [--rounds 2] [--ablate]

DIR is an unpacked earlier tree (for example `git archive <commit>` into a
directory that .gitignore lists). Libraries are built from
`<tree>/gpsat_tpu_torch/csrc/cholesky.cu`, each with its own tree's headers:
"change" (this tree) and, with DIR, "parent". An entry that still takes the
`winv` scratch argument (the design before the shared 128-factor) gets one.

Each kernel's output is first held against `cholesky_reference` with
chip_smoke.py's bounds (2e-4 absolute, max |L L^T - K| <= 1e-5 N), and the
parent's L against the change's bit for bit (`torch.equal`; reported, not
required). Then the
variants are timed in the order parent, change, library, library, change,
parent (repeated --rounds times) on chip_smoke.py's kernel-3 input, with
chip_smoke.py's CUDA-event timers: per call (one call between an event pair,
median of 20) and back to back (20 calls between one event pair, divided by
20, median of 5). Last, each kernel's device time per __global__ function,
from torch.profiler over 5 calls. The kernels are called through their C
entry, so the package's launch counters do not move. Prints one JSON line per
measurement and writes them all to chiprun_out/bench_cholesky.json. Without
a card it exits non-zero.

With --ablate, it also builds this tree's kernel with one part cut out at a
time (timing only: these outputs are wrong, and no check is made) and times
each per call with its split by __global__, to show where the time goes:
"no_panel" (the diagonal kernel's panel), "no_inverse" (the panel and the
inverse before it), "trailing_no_c" (the trailing kernel's loads and stores
of C), "trailing_no_ffma" (its products), and "trailing_128_registers" (the
trailing kernel capped at 128 registers, two blocks per SM, outputs right).
Each cut is a text edit of cholesky.cu that must match exactly once.
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
B, N = 512, 512
WINV_ARG = "void* winv"  # the earlier entry's scratch for the diagonal block's inverse
ABLATIONS = {
    "no_panel": [("panel(S, D, A, W, n, k);", "")],
    "no_inverse": [("panel(S, D, A, W, n, k);", ""), ("f128::invert(A, W);", "")],
    "trailing_no_c": [
        ("acc[i][j] = active && (!diag || r >= c) ? C[static_cast<size_t>(r) * n + c] : 0.0f;", "acc[i][j] = 0.0f;"),
        ("    if (!active) return;\n    float* D", "    if (!active || k >= 0) return;\n    float* D"),
    ],
    "trailing_no_ffma": [("        if (active) {\n            const float* sa", "        if (active && k < 0) {\n            const float* sa")],
    "trailing_128_registers": [("__launch_bounds__(TRAIL_THREADS, 1)", "__launch_bounds__(TRAIL_THREADS, 2)")],
}


def ablated(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"cholesky.cu has no single {old!r} to edit")
        text = text.replace(old, new)
    return text


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_cholesky: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench_panel_chol import build
    from chip_smoke import F32_FLOPS_PER_S, back_to_back_ms, device_ms_by_kernel, spd_batch, time_ms
    from gpsat_tpu_torch.ops import cholesky as CH

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    trees = {"change": ROOT}
    if args.parent is not None:
        trees["parent"] = args.parent.resolve()
    jobs = {}
    for name, tree in trees.items():
        csrc = tree / "gpsat_tpu_torch" / "csrc"
        jobs[f"cholesky_{name}"] = (csrc / "cholesky.cu", (csrc / "cholesky.cu").read_text(), csrc)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = dict(zip(trees, pool.map(lambda kv: build(kv[0], *kv[1]), jobs.items())))
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)

    K = spd_batch(B, N, seed=2)
    Lr = CH.cholesky_reference(K)
    stream = torch.cuda.current_stream().cuda_stream

    fns, outs, records = {}, {}, []
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        entry = lib.gpsat_cholesky_f32
        with_winv = WINV_ARG in jobs[f"cholesky_{name}"][1]
        entry.argtypes = [ctypes.c_void_p] * (3 if with_winv else 2) + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        entry.restype = ctypes.c_int
        L = torch.empty_like(K)
        tensors = [K, L]
        if with_winv:
            tensors.append(torch.empty((B, CH.BLOCK, CH.BLOCK), dtype=K.dtype, device=K.device))

        def call(entry=entry, tensors=tuple(tensors)):  # the tensors live as long as the call
            err = entry(*(t.data_ptr() for t in tensors), B, N, stream)
            if err != 0:
                raise RuntimeError(f"launch failed: cudaError {err}")
            return tensors[1]

        call()
        torch.cuda.synchronize()
        err = float((L - Lr).abs().max())
        err_LLt = float((torch.matmul(L, L.transpose(1, 2)) - K).abs().max())
        ok = err <= 2e-4 and err_LLt <= 1e-5 * N
        rec = {"check": name, "winv_scratch": with_winv, "max_abs_err": err, "max_abs_LLt_minus_K": err_LLt, "ok": ok}
        print(json.dumps(rec), flush=True)
        records.append(rec)
        if not ok:
            raise RuntimeError(f"{name} disagrees with the plain version: {rec}")
        fns[name] = call
        outs[name] = L.clone()

    if "parent" in outs:
        rec = {"bit_identical_to_parent": torch.equal(outs["parent"], outs["change"])}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    del outs

    fns["library"] = lambda: torch.linalg.cholesky_ex(K)
    first = [n for n in ("parent", "change") if n in fns] + ["library"]
    order = (first + first[::-1]) * args.rounds
    for turn, name in enumerate(order):
        fn = fns[name]
        rec = {"turn": turn, "variant": name, "shape": [B, N, N], "ms": time_ms(fn),
               "ms_back_to_back": back_to_back_ms(fn)}
        print(json.dumps(rec), flush=True)
        records.append(rec)

    split = {name: device_ms_by_kernel(fns[name], "chol_") for name in paths}
    print(json.dumps({"device_ms_by_kernel": split}), flush=True)

    ablations = {}
    if args.ablate:
        here = ROOT / "gpsat_tpu_torch" / "csrc"
        text = (here / "cholesky.cu").read_text()
        for name, edits in ABLATIONS.items():
            lib = ctypes.CDLL(str(build(f"cholesky_{name}", here / "cholesky.cu", ablated(text, edits), here)))
            entry = lib.gpsat_cholesky_f32
            entry.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            entry.restype = ctypes.c_int
            L = torch.empty_like(K)

            def call(entry=entry, L=L):
                err = entry(K.data_ptr(), L.data_ptr(), B, N, stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: cudaError {err}")

            ablations[name] = {"ms": time_ms(call), "device_ms_by_kernel": device_ms_by_kernel(call, "chol_")}
            print(json.dumps({"ablation": name, **ablations[name]}), flush=True)

    summary = {"card": card, "bound_ms": B * N**3 / 3.0 / F32_FLOPS_PER_S * 1e3, "device_ms_by_kernel": split,
               "ablations": ablations}
    for name in fns:
        rows = [r for r in records if r.get("variant") == name]
        summary[name] = {k: float(np.median([r[k] for r in rows])) for k in ("ms", "ms_back_to_back")}
    print(json.dumps({"summary": summary}), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "bench_cholesky.json").write_text(json.dumps({"summary": summary, "records": records}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
