"""Prime a fresh machine for canonical bucket shapes.

    python -m gpsat_tpu_torch.cli prime_cache --model gpr --shapes 128x512x64,128x1024x64

The port's counterpart of ``gpsat_tpu/prime_cache.py``. The JAX package
compiles one XLA program per bucket shape and fills the persistent
compilation cache ahead of a run. The port compiles no programs: what
persists across processes is the build of its libraries, so priming first
builds every library the model's route uses (on the card, ``nvcc`` for
kernels 1-3, ``csrc/{block_chol,panel_chol,cholesky}.cu``; everywhere,
g++ for the host library ``csrc/host/gpsat_native.cpp``), timed per
library (0 where it was already built). Then, in the calling process, it
makes one warm-up call of the runner per bucket shape at the engine's
padded width (``engine.padded_width(B, pad_multiple, n_dev)``: the width
``run_tile_batch`` pads the bucket to), which loads the CUDA modules and
the cuBLAS handles and fills the caching allocator for that shape.

It runs on the card unless given ``device="cpu"`` (``--cpu``), and raises
without a card. The defaults follow the JAX module's: f32 and jitter 1e-5 on
the card, f64 and jitter 0 on the CPU.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np

CUDA_KERNELS = ("block_chol", "panel_chol", "cholesky", "mm3xtf32")
HOST_LIBRARY = "gpsat_native"
# the warm-up runner's iterations: it loads the modules, it does not fit
WARMUP_ITER = 2


def _core_for(model: str, on_card: bool, **model_kwargs):
    jitter = model_kwargs.pop("jitter", 1e-5 if on_card else 0.0)
    if model in ("gpr", "GPRModel", "GPflowGPRModel"):
        from gpsat_tpu_torch.models.functional import make_gpr_core

        return make_gpr_core(jitter=jitter, **model_kwargs)
    if model in ("sgpr", "SGPRModel", "GPflowSGPRModel"):
        from gpsat_tpu_torch.models.sgpr import make_sgpr_core

        return make_sgpr_core(jitter=jitter, **model_kwargs)
    if model in ("svgp", "SVGPModel", "GPflowSVGPModel"):
        from gpsat_tpu_torch.models.svgp import make_svgp_core

        return make_svgp_core(jitter=jitter, **model_kwargs)
    if model in ("vff", "VFFModel", "GPflowVFFModel"):
        from gpsat_tpu_torch.models.vff import make_vff_core

        return make_vff_core(**model_kwargs)
    if model in ("asvgp", "ASVGPModel", "GPflowASVGPModel"):
        from gpsat_tpu_torch.models.asvgp import make_asvgp_core

        return make_asvgp_core(**model_kwargs)
    raise ValueError(f"unknown model: {model}")


def build_libraries(on_card: bool) -> dict:
    """Build the host library and, on the card, the three CUDA kernels (one
    nvcc per source, all started together): seconds per library, 0.0 for a
    library already built."""
    from gpsat_tpu_torch.ops import _build

    def timed(name, path_of, build):
        if path_of(name).exists():
            return name, 0.0
        t0 = time.perf_counter()
        build(name)
        return name, time.perf_counter() - t0

    jobs = [(HOST_LIBRARY, _build.host_library_path, _build.build_host_library)]
    if on_card:
        jobs += [(k, _build.library_path, _build.build_library) for k in CUDA_KERNELS]
    with ThreadPoolExecutor(len(jobs)) as pool:
        return dict(pool.map(lambda job: timed(*job), jobs))


def warmup_batch(B: int, N: int, P: int, D: int, dtype, seed: int = 0):
    """A full bucket of B random tiles of N points and P predictions."""
    from gpsat_tpu_torch.parallel.batching import TileBatch

    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, size=(B, N, D)).astype(dtype)
    y = (np.sin(X[..., 0]) + 0.1 * rng.normal(size=(B, N))).astype(dtype)
    return TileBatch(X=X, y=y, mask=np.ones((B, N), dtype=dtype), Xnew=rng.uniform(-3, 3, size=(B, P, D)).astype(dtype),
                     pred_mask=np.ones((B, P), dtype=dtype), obs_mean=np.zeros(B, dtype=dtype),
                     expert_index=np.arange(B), num_obs=np.full(B, N), expert_loc=np.zeros((B, D), dtype=dtype))


def prime(
    shapes: Sequence[Tuple[int, int, int]],
    model: str = "gpr",
    *,
    D: int = 2,
    dtype=None,
    optim_kwargs: Optional[dict] = None,
    mesh=None,
    device=None,
    pad_multiple: Optional[int] = None,
    verbose: bool = True,
    **model_kwargs,
) -> dict:
    """Build the libraries, then warm the runner up once per (B, N, P)
    bucket shape at the engine's padded width.

    Returns {"libraries": {name: seconds}, "shapes": {(B, N, P):
    {"padded_width": W, "seconds": s}}}. The runner is built as
    ``LocalExpertOI`` builds it (``make_runner_for`` with the core's fixed
    params and ``optim_kwargs``' line search), its loop cut to
    ``WARMUP_ITER`` iterations.
    """
    import torch

    from gpsat_tpu_torch.parallel.engine import (
        make_runner_for,
        padded_width,
        resolve_device,
        resolve_mesh,
        run_tile_batch,
    )

    dev = resolve_device(device)
    mesh = resolve_mesh(mesh, dev)
    on_card = mesh[0].type == "cuda"
    if dtype is None:
        dtype = torch.float32 if on_card else torch.float64
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    optim_kwargs = dict(optim_kwargs or {})

    libraries = build_libraries(on_card)
    if verbose:
        for name, sec in libraries.items():
            print(f"built {name} in {sec:.2f}s" if sec else f"{name} was built already")

    core = _core_for(model, on_card, **model_kwargs)
    kw = dict(fixed_params=tuple(core.default_fixed_params), max_iter=WARMUP_ITER, mesh=mesh)
    if core.optimizer != "adam":
        kw["linesearch"] = optim_kwargs.get("linesearch")
    runner = make_runner_for(core, **kw)

    out = {}
    for B, N, P in shapes:
        width = padded_width(int(B), pad_multiple, len(mesh))
        batch = warmup_batch(int(B), int(N), int(P), D, np_dtype)
        if on_card:
            torch.cuda.synchronize(mesh[0])
        t0 = time.perf_counter()
        run_tile_batch(batch, {}, runner, core, mesh=mesh, pad_multiple=pad_multiple)
        if on_card:
            torch.cuda.synchronize(mesh[0])
        sec = time.perf_counter() - t0
        out[(int(B), int(N), int(P))] = {"padded_width": width, "seconds": sec}
        if verbose:
            print(f"primed {model} (B={width}, N={N}, P={P}) in {sec:.2f}s")
    return {"libraries": libraries, "shapes": out}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="python -m gpsat_tpu_torch.cli prime_cache",
                                 description="Build the port's libraries and warm the runner up per bucket shape.")
    ap.add_argument("--model", default="gpr")
    ap.add_argument("--shapes", default="128x512x64",
                    help="comma-separated BxNxP bucket shapes, e.g. 128x512x64,128x1024x64")
    ap.add_argument("--dims", type=int, default=2)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    ap.add_argument("--pad-multiple", type=int, default=None)
    ap.add_argument("--linesearch", default=None)
    ap.add_argument("--jitter", type=float, default=None)
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:  # --help or a usage error: the dispatcher takes a return code
        return e.code

    shapes = [tuple(int(x) for x in s.split("x")) for s in args.shapes.split(",")]
    optim_kwargs = {"linesearch": args.linesearch} if args.linesearch else {}
    model_kwargs = {} if args.jitter is None else {"jitter": args.jitter}
    res = prime(shapes, model=args.model, D=args.dims, optim_kwargs=optim_kwargs, device="cpu" if args.cpu else None,
                pad_multiple=args.pad_multiple, **model_kwargs)
    print(f"primed: {len(shapes)} shape(s), {sum(v['seconds'] for v in res['shapes'].values()):.2f}s of warm-up, "
          f"{sum(res['libraries'].values()):.2f}s of builds")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
