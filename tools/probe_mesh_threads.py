"""Where the time goes when two mesh shards share one card from two host threads.

    python tools/probe_mesh_threads.py [--out probe.json]

Needs a card. Runs chip_smoke.py phase 14's f32 sweep (phase 7's 1,664
experts through ``experts.sweep``, no polish) on ``cuda:0``, each way after
one warm-up run:

- ``whole``: the bucket on one shard (phase 14 (a));
- ``halves_serial``: the bucket's two shards of 832, as a mesh of two
  splits it, swept alone one after the other from one thread
  (``pad_multiple`` 64 keeps each at its shard's width);
- ``two_threads``: the mesh of the card twice (two host threads, each on a
  stream of its own: phase 14 (b)), at the interpreter's default GIL
  switch interval, and at 0.1 ms and 50 ms (``sys.setswitchinterval``).

Then a plain probe of the GIL: 40,000 in-place adds on a one-element
tensor from one thread, and the same split over two threads (on the card,
each thread on a stream of its own), on the card and on the CPU.

Every run reports its wall, the process's CPU seconds (``time.process_time``)
and its voluntary and involuntary context switches (``getrusage``); the
sweeps add the engine's dispatch seconds (the lockstep loop, from the
sweep's ``timers``) and the slowest lane's iterations in each shard. One
JSON line per run is printed, and with ``--out`` all of them are written
to that file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import resource
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gpsat_tpu_torch import experts  # noqa: E402
from gpsat_tpu_torch.data.prediction_locations import PredictionLocations  # noqa: E402
from gpsat_tpu_torch.parallel.engine import default_mesh, padded_width  # noqa: E402

ADDS = 40_000
SWITCH_INTERVALS_S = (None, 1e-4, 5e-2)


def measure(fn) -> dict:
    """Wall, process CPU seconds and context switches of ``fn()``, the card
    idle before and after; ``fn``'s dict joins the result."""
    torch.cuda.synchronize()
    r0, c0, t0 = resource.getrusage(resource.RUSAGE_SELF), time.process_time(), time.perf_counter()
    extra = fn()
    torch.cuda.synchronize()
    wall, cpu, r1 = time.perf_counter() - t0, time.process_time() - c0, resource.getrusage(resource.RUSAGE_SELF)
    return {"wall_s": wall, "cpu_s": cpu, "voluntary_switches": r1.ru_nvcsw - r0.ru_nvcsw,
            "involuntary_switches": r1.ru_nivcsw - r0.ru_nivcsw, **(extra or {})}


def run_sweep(obs, locs, pred_loc, mesh, pad_multiple):
    """(buckets, timers) of phase 14's f32 sweep of ``locs`` over ``mesh``."""
    timers = {}
    kw = {**cs.OI_KW, "dtype": torch.float32, "optim_kwargs": cs.MESH_OPTIM, "pad_multiple": pad_multiple}
    out = [r for r in experts.sweep(obs, locs, pred_loc=pred_loc, mesh=mesh, timers=timers, **kw)
           if not r.get("skipped")]
    return out, timers


def adds(device, threads: int) -> dict:
    """ADDS in-place adds of one-element tensors on ``device``, split over
    ``threads`` host threads (on a card, each on a stream of its own)."""
    xs = [torch.zeros(1, device=device) for _ in range(threads)]
    streams = [torch.cuda.Stream(device) if device.type == "cuda" else None for _ in range(threads)]

    def work(i):
        with torch.cuda.stream(streams[i]) if streams[i] is not None else contextlib.nullcontext():
            x = xs[i]
            for _ in range(ADDS // threads):
                x.add_(1)
            if streams[i] is not None:
                streams[i].synchronize()

    if threads == 1:
        work(0)
    else:
        ts = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    assert sum(float(x.sum()) for x in xs) == ADDS
    return {"adds": ADDS, "threads": threads, "device": str(device)}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write every run's JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_mesh_threads: no card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    runs = [{"run": "device", "card": card, "torch": torch.__version__, "python": sys.version.split()[0],
             "switch_interval_s": sys.getswitchinterval()}]

    def emit(row):
        runs.append(row)
        print(json.dumps(row), flush=True)

    obs, locs, grid = cs.pipeline_inputs()
    pred_loc = PredictionLocations("from_dataframe", coords_col=["x", "y"], df=grid, max_dist=cs.OI_MAX_DIST)
    one, two = default_mesh([0]), default_mesh([0, 0])
    pad = cs.OI_KW["pad_multiple"]
    run_sweep(obs, locs, pred_loc, one, pad)  # warm-up: the kernel build, the allocator's pool
    whole = {}

    def sweep_whole():
        out, timers = run_sweep(obs, locs, pred_loc, one, pad)
        whole["rows"] = np.concatenate([r["expert_index"] for r in out])
        return {"dispatch_s": timers["device_dispatch"], "iters_max": [int(max(r["num_iter"].max() for r in out))]}

    emit({"run": "whole", **measure(sweep_whole)})
    rows = whole["rows"]
    per = padded_width(len(rows), pad, 2) // 2
    halves = [{c: v[rows[h * per:(h + 1) * per]] for c, v in locs.items()} for h in range(2)]

    def sweep_halves():
        dispatch, iters = 0.0, []
        for half in halves:
            out, timers = run_sweep(obs, half, pred_loc, one, 64)
            assert len(out) == 1, f"a half ran as {len(out)} buckets"
            dispatch += timers["device_dispatch"]
            iters.append(int(max(r["num_iter"].max() for r in out)))
        return {"dispatch_s": dispatch, "iters_max": iters}

    run_sweep(obs, locs, pred_loc, two, pad)  # warm-up: the second stream's pool
    emit({"run": "halves_serial", **measure(sweep_halves)})
    default_interval = sys.getswitchinterval()
    for interval in SWITCH_INTERVALS_S:
        sys.setswitchinterval(default_interval if interval is None else interval)

        def sweep_two():
            out, timers = run_sweep(obs, locs, pred_loc, two, pad)
            return {"dispatch_s": timers["device_dispatch"], "iters_max": cs.shard_launches(out, 2)[1]}

        try:
            emit({"run": "two_threads", "switch_interval_s": sys.getswitchinterval(), **measure(sweep_two)})
        finally:
            sys.setswitchinterval(default_interval)
    for device in (torch.device("cuda", 0), torch.device("cpu")):
        adds(device, 2)  # warm-up
        for threads in (1, 2):
            emit({"run": "adds", **measure(lambda: adds(device, threads))})

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(runs, indent=1))
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
