"""Rehearse chip_smoke.py's phases 10 (svgp), 11 (zoo), 12 (host), 13 (prep), 14 (mesh), 15 (xval), 16 (cli) and 17 (formats) on the CPU, before a run on the card.

    python tools/rehearse_chip_smoke.py [--parts a b c d e vff asvgp host prep_a prep_b prep_c mesh xval cli formats
                                                 formats_codec]
                                        [--lanes B] [--threads T] [--identity-natgrad] [--expert-stride S]

Runs the phases' own functions with every entry point's default device
set to the CPU and the CUDA memory calls stubbed, so the iteration counts,
objectives and accuracy numbers that fix the phases' bounds can be read
without a card. A failed check is printed and counted instead of raised:
the kernel-launch checks always fail here, since the CPU runs each
kernel's plain version. Parts a-e are phase 10's, "vff" and "asvgp" phase
11's lanes, "host" phase 12, "prep_a" to "prep_c" phase 13's parts,
"mesh" phase 14 (its meshes are the CPU, once or twice, its children run
with the same stubs, and phase 7's f32 fit is run first for (a) to hold
to), "xval" phase 15 (the host library built first), "cli" phase 16 and
"formats" phase 17 (phase 7 run first for them to hold to; default:
phase 10's), "formats_codec" the parts of phase 17 that need no sweep of
phase 7 ((a) the fixtures, (d) load_params from the v1.8 and the
version-4 results fixtures, (f) the lzf decoders, (g) the version-4 read
MB/s; a few seconds, h5py never imported). ``--lanes`` cuts (a)-(c)'s batch (default: the
phase's 128) and phase 13 (a)'s (the phase's 512). ``--identity-natgrad`` is the mutation check
of (c)'s bound: it runs (c) once more with the natural-gradient step
replaced by the identity, so q stays at its starting value, and prints
that run's negative-ELBO gap to (a). ``--expert-stride S`` keeps every
S-th expert of phase 7's geometry in phase 11 (its full 1,664 experts
hold ~20 GB of [B, 448, 448] buffers: too much for a shared CPU). Exits
non-zero if a check other than a launch check failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gpsat_tpu_torch import experts, postprocess  # noqa: E402
from gpsat_tpu_torch.models.svgp import make_svgp_core  # noqa: E402
from gpsat_tpu_torch.parallel import engine  # noqa: E402
from gpsat_tpu_torch.utils.flops import sgpr_iter_flops, svgp_iter_flops  # noqa: E402


def _on_cpu(failed: list):
    def resolve_device(device=None):
        return torch.device(device if device is not None else "cpu")

    def check(cond, msg):
        if not cond:
            failed.append(msg)
            print(f"check failed: {msg[:300]}", flush=True)

    engine.resolve_device = experts.resolve_device = postprocess.resolve_device = resolve_device
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    cs.check = check


def _mesh_on_cpu(expert_stride: int):
    """Phase 14's meshes on the CPU: the default mesh is the CPU once, a
    named one the CPU once per entry; the children apply the same stubs."""
    def default_mesh(devices=None):
        return (torch.device("cpu"),) * (1 if devices is None else len(list(devices)))

    engine.default_mesh = default_mesh
    torch.cuda.device_count = lambda: 1
    cs.MESH_CHILD_CODE = (
        "import sys; sys.path.insert(0, sys.argv[1]); import tools.rehearse_chip_smoke as r; "
        f"r._on_cpu([]); r._mesh_on_cpu({expert_stride}); r._stride({expert_stride}); "
        "r.cs.mesh_child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])")


def _stride(stride: int):
    """Keep every ``stride``-th expert of phase 7's geometry."""
    if stride <= 1:
        return
    full = cs.pipeline_inputs

    def strided():
        obs, experts, grid = full()
        return obs, {c: v[::stride] for c, v in experts.items()}, grid

    cs.pipeline_inputs = strided


def _gap(tag, res, res_a):
    gap = res["objective"] - res_a["objective"]
    cs.log(f"rehearse_{tag}_vs_collapsed", neg_elbo_gap_min=float(gap.min()), neg_elbo_gap_max=float(gap.max()),
           neg_elbo_gap_mean=float(gap.mean()), above_bound=cs.SVGP_ELBO_ABOVE, below_bound=cs.SVGP_ELBO_BELOW)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", nargs="+", default=list("abcde"), choices=[*"abcde", "vff", "asvgp", "host", "prep_a", "prep_b", "prep_c", "mesh",
                                                                      "xval", "cli", "formats", "formats_codec"])
    ap.add_argument("--expert-stride", type=int, default=1)
    ap.add_argument("--lanes", type=int, default=cs.SVGP_B)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--identity-natgrad", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    failed: list = []
    _on_cpu(failed)
    t0 = time.perf_counter()
    parts = set(args.parts)
    _stride(args.expert_stride)
    if parts & {"host", "mesh", "cli", "formats", "formats_codec"}:  # LocalExpertOI.run takes the default mesh
        _mesh_on_cpu(args.expert_stride)
    for tag in ("vff", "asvgp"):
        if tag in parts:
            cs.zoo_lane(tag, profile=False)
    if "host" in parts:
        cs.phase_host()
    if "prep_a" in parts:
        cs.B = args.lanes
        cs.phase_profiled(*cs.bench_workload(), False, kernel=cs.PREP_PROFILED_KERNEL, tag="prep_profiled_rq")
    if "prep_b" in parts:
        cs.phase_prep_multioutput()
    if "prep_c" in parts:
        cs.phase_prep_data()
    if "mesh" in parts:
        buckets, seconds, _ = cs.mesh_sweep(None)
        f32 = cs.by_expert(buckets, ("num_iter", "objective", "f_mean", "f_var"))
        cs.log("rehearse_phase7_f32", experts=len(f32), seconds=seconds)
        cs.phase_mesh(f32)
    if "xval" in parts:
        from gpsat_tpu_torch.ops import _build

        t = time.perf_counter()
        _build.build_host_library(cs.HOST_LIBRARY)
        cs.phase_xval(time.perf_counter() - t)
    if "formats_codec" in parts:
        _formats_codec()
    if parts & {"cli", "formats"}:
        _, _, it_max, polished = cs.phase_oi(False)
        if "cli" in parts:
            cs.phase_cli(polished, it_max)
        if "formats" in parts:
            cs.phase_formats(polished, it_max)
    if not parts & set("abcde"):
        return _done(failed, t0)
    batch = cs.make_large_tiles(args.lanes, cs.SVGP_N, cs.SVGP_P, cs.D, np.float32, min_fill=0.6)
    kw = dict(kernel="Matern32", jitter=cs.SVGP_JITTER, num_inducing_points=cs.SVGP_M)
    if parts & {"a", "c"}:
        col = make_svgp_core(**kw)
        res_a, _ = cs.drive_svgp("collapsed", col, batch, {"max_iter": cs.SVGP_MAX_ITER["collapsed"]},
                                 lambda it: 2 * (it + 1) + 3, sgpr_iter_flops(cs.SVGP_N, cs.SVGP_M, cs.D))
        cs.svgp_f64_reference("collapsed", col, batch, res_a)
    if "b" in parts:
        bern = make_svgp_core(likelihood="Bernoulli", **kw)
        labels = batch.__class__(**{**batch.__dict__, "y": (batch.y > 0).astype(np.float32)})
        res_b, _ = cs.drive_svgp("bernoulli", bern, labels, {"max_iter": cs.SVGP_MAX_ITER["bernoulli"]},
                                 lambda it: it + 4, svgp_iter_flops(cs.SVGP_N, cs.SVGP_M, cs.D))
        cs.svgp_f64_reference("bernoulli", bern, labels, res_b)
    if "c" in parts:
        nat = make_svgp_core(natural_gradients=True, gamma=0.5, **kw)
        cores = [("adam_natgrad", nat)]
        if args.identity_natgrad:
            keep_q = dataclasses.replace(nat, natgrad_update=lambda u, data: {k: u[k] for k in nat.natgrad_params})
            cores.append(("adam_identity_natgrad", keep_q))
        for tag, core in cores:
            res_c, _ = cs.drive_svgp(tag, core, batch, cs.SVGP_ADAM_KW, lambda it: 2 * it + 4,
                                     2 * svgp_iter_flops(cs.SVGP_N, cs.SVGP_M, cs.D))
            _gap(tag, res_c, res_a)
    if "d" in parts:
        cs.phase_svgp_linesearch()
    if "e" in parts:
        cs.phase_svgp_config()
    return _done(failed, t0)


def _formats_codec():
    """Phase 17's parts that need no sweep of phase 7, with h5py never
    imported."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="rehearse_formats_") as tmp:
        root = Path(tmp)
        cs.formats_fixtures()
        (root / "load").mkdir()
        launches, stored = cs.formats_load_params(root / "load")
        (root / "load_v4").mkdir()
        cs.formats_load_params_v4(root / "load_v4", launches, stored)
        cs.formats_lzf()
        cs.formats_throughput(root)
        (root / "restart").mkdir()
        cs.formats_restart(root / "restart")
        (root / "vds").mkdir()
        cs.vds_files(root / "vds")
        cs.formats_virtual_read(root / "vds")
    cs.log("formats_h5py", loaded="h5py" in sys.modules)
    cs.check("h5py" not in sys.modules, "formats (e): h5py was imported")


def _done(failed, t0) -> int:
    others = [m for m in failed if "launches" not in m]
    cs.log("rehearse_done", seconds=time.perf_counter() - t0, failed_checks=others,
           launch_checks_failed=len(failed) - len(others))
    return 1 if others else 0


if __name__ == "__main__":
    sys.exit(main())
