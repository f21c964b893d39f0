"""Time kernel 2 (factor_panels: L and L^-1 of [512, 128, 128] f32 blocks) on
one NVIDIA card, in turns with an earlier tree's version of the same kernel.

    python3 bench_panel_chol.py [--parent DIR] [--rounds 2]

DIR is an unpacked earlier tree (for example `git archive <commit>` into a
directory that .gitignore lists). With it, three libraries are built from
`<tree>/gpsat_tpu_torch/csrc/panel_chol.cu`:

- "parent":            DIR's kernel as it is;
- "parent_no_inverse": DIR's kernel with its inverse switched off (the
                       `/*kInverse=*/true` argument of the shared 128-step
                       factor replaced by `false`), which times the factor's
                       own steps without the inverse's; built only where
                       DIR's source has that argument (the unblocked design,
                       before the blocked one), and left out otherwise;
- "change":            this tree's kernel.

Each variant is timed in the order parent, parent_no_inverse, change, change,
parent_no_inverse, parent (repeated --rounds times) on chip_smoke.py's
kernel-2 input, with chip_smoke.py's CUDA-event timers: per call (one launch
between an event pair, median of 20) and back to back (20 launches between
one event pair, divided by 20, median of 5). The library pair `cholesky_ex`
+ `solve_triangular` is timed the same way.
Every variant's output is first held against `factor_panels_reference` (the
no-inverse variant on L only), and the parent's L and Linv against the
change's bit for bit (`torch.equal`; reported, not required). The kernels
are called through their C entry, so the package's launch counters do not
move. Prints one JSON line per measurement and writes them all to
chiprun_out/bench_panel_chol.json. Without a card it exits non-zero.
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
B, T = 512, 128
NO_INVERSE = ("/*kInverse=*/true", "/*kInverse=*/false")


def build(name: str, source: Path, src_text: str, include: Path) -> Path:
    from gpsat_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "bench"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{name}.cu"
    cu.write_text(src_text)
    lib = out / f"lib{name}.so"
    cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-I", str(include), "-shared", "-Xcompiler", "-fPIC",
           "-o", str(lib), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name} ({source}):\n{proc.stdout}\n{proc.stderr}")
    print(f"[{name}] {source}\n{(proc.stdout + proc.stderr).strip()}", flush=True)
    return lib


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_panel_chol: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import HBM_BYTES_PER_S, back_to_back_ms, factor_bytes, spd_batch, time_ms
    from gpsat_tpu_torch.ops import panel_chol as PC

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    here = ROOT / "gpsat_tpu_torch" / "csrc"
    jobs = {"change": (here / "panel_chol.cu", (here / "panel_chol.cu").read_text(), here)}
    if args.parent is not None:
        pdir = args.parent.resolve() / "gpsat_tpu_torch" / "csrc"
        text = (pdir / "panel_chol.cu").read_text()
        jobs["parent"] = (pdir / "panel_chol.cu", text, pdir)
        if text.count(NO_INVERSE[0]) == 1:
            jobs["parent_no_inverse"] = (pdir / "panel_chol.cu", text.replace(*NO_INVERSE), pdir)
        else:
            print(json.dumps({"note": f"{pdir / 'panel_chol.cu'} has no {NO_INVERSE[0]}: no parent_no_inverse"}),
                  flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = dict(zip(jobs, pool.map(lambda kv: build(kv[0], *kv[1]), jobs.items())))
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)

    K = spd_batch(B, T, seed=1)
    Lr, Wr = PC.factor_panels_reference(K)
    eye = torch.eye(T, device=K.device)
    stream = torch.cuda.current_stream().cuda_stream

    fns, outs, records = {}, {}, []
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        entry = lib.gpsat_panel128_f32
        entry.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        entry.restype = ctypes.c_int
        L, W = torch.empty_like(K), torch.empty_like(K)

        def call(entry=entry, L=L, W=W):
            err = entry(K.data_ptr(), L.data_ptr(), W.data_ptr(), B, stream)
            if err != 0:
                raise RuntimeError(f"launch failed: cudaError {err}")

        call()
        torch.cuda.synchronize()
        err_L = float((torch.tril(L) - Lr).abs().max())
        err_W = float((W - Wr).abs().max()) if name != "parent_no_inverse" else None
        ok = err_L <= 2e-4 and (err_W is None or err_W <= 2e-5)
        rec = {"check": name, "max_abs_err_L": err_L, "max_abs_err_Linv": err_W, "ok": ok}
        print(json.dumps(rec), flush=True)
        records.append(rec)
        if not ok:
            raise RuntimeError(f"{name} disagrees with the plain version: {rec}")
        fns[name] = call
        outs[name] = (L.clone(), W.clone())

    if "parent" in outs:
        same_L = torch.equal(outs["parent"][0], outs["change"][0])
        same_W = torch.equal(outs["parent"][1], outs["change"][1])
        rec = {"bit_identical_to_parent": same_L and same_W, "L": same_L, "Linv": same_W}
        print(json.dumps(rec), flush=True)
        records.append(rec)

    def library():
        Lc, _ = torch.linalg.cholesky_ex(K)
        return torch.linalg.solve_triangular(Lc, eye.expand(B, T, T), upper=False)

    fns["library"] = library
    first = [n for n in ("parent", "parent_no_inverse", "change") if n in fns] + ["library"]
    order = (first + first[::-1]) * args.rounds
    for turn, name in enumerate(order):
        fn = fns[name]
        rec = {"turn": turn, "variant": name, "shape": [B, T, T], "ms": time_ms(fn),
               "ms_back_to_back": back_to_back_ms(fn)}
        print(json.dumps(rec), flush=True)
        records.append(rec)

    summary = {"card": card, "bound_ms": factor_bytes(B, T, 2) / HBM_BYTES_PER_S * 1e3}
    for name in fns:
        rows = [r for r in records if r.get("variant") == name]
        summary[name] = {k: float(np.median([r[k] for r in rows])) for k in ("ms", "ms_back_to_back")}
    print(json.dumps({"summary": summary}), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "bench_panel_chol.json").write_text(json.dumps({"summary": summary, "records": records}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
