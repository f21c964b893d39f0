"""Batched expert execution on one device or over a mesh of devices.

Port of ``gpsat_tpu/parallel/engine.py``. The JAX engine vmaps one tile's
fit-and-predict over the expert axis; here every step acts on the whole
[B, ...] batch: batched single-eval L-BFGS on the masked objective, then the
masked posterior predict. Dead tiles (mask all-zero) pad the batch to a
power of two (and a multiple of the mesh) and are dropped on the host.

The mesh (``default_mesh``, ``resolve_mesh``) is a tuple of devices, one
shard each; one device may stand in for several, and a run given only a
device runs on the mesh of that device, one shard, inline. Where the JAX engine
``shard_map``s the expert axis, a meshed runner splits the padded bucket
into equal contiguous shards in row order, drives each from a host thread
of its own on its device (on a stream of its own on a card), each to its
own trip count, and puts the results back together in row order on the
mesh's first device. Experts are independent: nothing passes between the
shards. An exception in any shard is raised in the caller.

Unconverged-lane compaction (``run_tile_batch_carry``,
``run_tile_batch_two_stage``): the batch runs in lockstep until its slowest
lane stops, so a head run takes a few iterations on the whole batch and a
tail run finishes only the lanes the head left unconverged, gathered by an
index on the device.

Cores whose ``optimizer`` is "adam" (the SVGP core's reference optimiser)
run ``make_batched_adam_runner`` instead: a per-lane Adam loop with the
reference's early stopping and, for cores with a natural-gradient hook,
the natural-gradient step of the variational parameters before each Adam
step.

Entry points default to the CUDA device and raise without one, unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from gpsat_tpu_torch.models.functional import ModelCore
from gpsat_tpu_torch.optim.lbfgs import _lane_where, check_linesearch, minimize_lbfgs
from gpsat_tpu_torch.parallel.batching import TileBatch, pad_batch_to, take_batch


def resolve_device(device=None) -> torch.device:
    """None means the CUDA device, which must exist: there is no fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} is not a visible CUDA device ({torch.cuda.device_count()} visible)")
    return dev


Mesh = Tuple[torch.device, ...]


def check_mesh(devices) -> Mesh:
    """``devices`` as a mesh: a non-empty tuple of resolved devices of one
    type. A mesh that mixes the CPU and CUDA, or names a missing card,
    raises."""
    devices = [torch.device("cuda", d) if isinstance(d, int) else torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    kinds = sorted({d.type for d in devices})
    if len(kinds) > 1:
        raise ValueError(f"a mesh mixes device types {kinds}: {devices}")
    return tuple(resolve_device(d) for d in devices)


def default_mesh(devices=None) -> Mesh:
    """The 1-D expert mesh: every visible CUDA device, or ``devices``, as a
    tuple of ``torch.device``. A list may name one device more than once,
    so that one card (or the CPU) stands in for several."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available for the default mesh; name the devices (e.g. ['cpu'] * 2)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return check_mesh(devices)


def resolve_mesh(mesh, device=None) -> Mesh:
    """The mesh a run uses, from the JSON forms of the JAX package's
    ``run(mesh=...)``: None (``device`` alone: the batch runs whole on it),
    "all" or True (every visible card; the CPU once when ``device`` is the
    CPU), an int n (the first n cards; the CPU n times when ``device`` is
    the CPU) or a sequence of devices. ``device`` is read only for None,
    "all" and an int."""
    if mesh is None:
        return (resolve_device(device),)
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if mesh is True or mesh == "all":
        return (torch.device("cpu"),) if on_cpu else default_mesh()
    if isinstance(mesh, (bool, str)):
        raise ValueError(f"mesh must be None, 'all', True, an int or a sequence of devices, got {mesh!r}")
    if isinstance(mesh, int):
        if mesh < 1:
            raise ValueError(f"a mesh of {mesh} devices")
        if on_cpu:
            return (torch.device("cpu"),) * mesh
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if mesh > visible:
            raise RuntimeError(f"mesh={mesh} names more cards than the {visible} visible")
        return default_mesh(range(mesh))
    if isinstance(mesh, (list, tuple)):
        return check_mesh(mesh)
    raise TypeError(f"mesh must be None, 'all', True, an int or a sequence of devices, got {type(mesh).__name__}")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _tree_cat(trees: list, dev: torch.device):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_cat([t[k] for t in trees], dev) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_cat(list(parts), dev) for parts in zip(*trees))
    return None if first is None else torch.cat([t.to(dev) for t in trees])


def run_on_mesh(mesh: Mesh, fn: Callable, args: tuple):
    """``fn(device, *shard_args)`` on each shard of ``args`` (a tree of
    [B, ...] arrays, B a multiple of the mesh size), the results' trees
    concatenated in row order on ``mesh[0]``.

    Shard i takes rows [i B/n, (i+1) B/n) and runs on ``mesh[i]`` from a
    host thread of its own, with the caller's grad mode; on a card, with
    that card as the thread's current device and a stream of its own that
    first waits for the caller's stream. Each thread synchronises its
    stream before it ends, and the caller its own after the concatenation,
    so no tensor of a shard is freed while a stream still reads it. A
    mesh of one device runs inline. The first exception of a shard is
    raised here, with the shard named in a note."""
    mesh = check_mesh(mesh)
    args = _tree_map(torch.as_tensor, args)
    n = len(mesh)
    widths = set()
    _tree_map(lambda t: widths.add(t.shape[0]), args)
    if len(widths) != 1 or next(iter(widths)) % n:
        raise ValueError(f"the leading axes {sorted(widths)} do not split into {n} equal shards")
    per = next(iter(widths)) // n
    grad = torch.is_grad_enabled()
    cuda = sorted({d for d in mesh if d.type == "cuda"}, key=str)
    callers = {d: torch.cuda.current_stream(d) for d in cuda}

    def shard(i):
        d = mesh[i]
        part = _tree_map(lambda t: t[i * per:(i + 1) * per], args)
        if d.type != "cuda":
            with torch.set_grad_enabled(grad):
                return fn(d, *_tree_map(lambda t: t.to(d), part))
        with torch.cuda.device(d):
            if n == 1:
                return fn(d, *_tree_map(lambda t: t.to(d), part))
            stream = torch.cuda.Stream(d)
            stream.wait_stream(callers[d])
            try:
                with torch.cuda.stream(stream), torch.set_grad_enabled(grad):
                    return fn(d, *_tree_map(lambda t: t.to(d), part))
            finally:
                # a failed shard drains its stream too, before the caller
                # frees the inputs it reads
                stream.synchronize()

    if n == 1:
        return shard(0)
    outs, errors = [None] * n, [None] * n

    def target(i):
        try:
            outs[i] = shard(i)
        except BaseException as e:  # raised in the caller below
            errors[i] = e

    threads = [threading.Thread(target=target, args=(i,), name=f"mesh-shard-{i}") for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, e in enumerate(errors):
        if e is not None:
            e.add_note(f"in mesh shard {i} of {n}, on {mesh[i]}")
            raise e
    out = _tree_cat(outs, mesh[0])
    for d in cuda:
        callers[d].synchronize()
    return out


def resolve_linesearch(linesearch: Optional[str], dtype) -> str:
    """The line search a run uses: ``linesearch``, or by compute dtype
    "single_eval" in f32 and "zoom" in f64 (the JAX engine's defaults).
    A name outside ``optim.lbfgs.LINESEARCHES`` raises ValueError."""
    return check_linesearch(linesearch if linesearch is not None else ("single_eval" if dtype == torch.float32 else "zoom"))


def padded_width(B: int, pad_multiple: Optional[int] = None, n_dev: int = 1) -> int:
    """The expert axis padded as the JAX engine pads it
    (``gpsat_tpu/parallel/engine.py:441-451``), so that different-sized
    buckets share shapes and a bucket divides the mesh: with
    ``pad_multiple``, to the next multiple of lcm(pad_multiple, n_dev);
    without it, doubling from n_dev until it reaches B, then up to a
    multiple of n_dev."""
    n = max(int(n_dev), 1)
    if pad_multiple:
        step = math.lcm(int(pad_multiple), n)
        return int(-(-B // step) * step)
    B_pad = n
    while B_pad < B:
        B_pad *= 2
    return int(-(-B_pad // n) * n)


def _check_runner(runner, mesh: Mesh):
    """A runner takes only the batches of the mesh it was built for."""
    if runner.mesh != mesh:
        raise ValueError(f"runner was built for mesh {runner.mesh}, batch runs on mesh {mesh}")


def _finalize_and_predict(core: ModelCore, u_opt: dict, data: dict, Xnew: torch.Tensor, optimise: bool):
    """(constrained params, predictions) at the optimum; ``finalize_params``
    runs only after an optimisation, as the predict-only contract says."""
    with torch.no_grad():
        cparams = core.forward(u_opt)
        if optimise and core.finalize_params is not None:
            cparams = core.finalize_params(cparams, data)
        return cparams, core.predict(cparams, data, Xnew)


def _fit_predict_batched(
    core: ModelCore,
    data: Dict[str, torch.Tensor],
    Xnew: torch.Tensor,
    uparams0: Dict[str, torch.Tensor],
    *,
    fixed_params: tuple,
    max_iter: int,
    optimise: bool,
    tol_grad: float,
    tol_f: float,
    memory_size: int,
    linesearch: Optional[str],
    max_linesearch_steps: int,
    init_state: Optional[dict],
    return_state: bool,
):
    """All padded tiles of a batch: optimise parameters, then predict.
    ``init_state`` resumes the L-BFGS state of an earlier run;
    ``return_state`` adds the final state to the results as "opt_state"."""
    if optimise and core.device_init is not None:
        with torch.no_grad():
            uparams0 = core.device_init(uparams0, data)
    u_free0 = {k: v for k, v in uparams0.items() if k not in fixed_params}
    u_fixed = {k: v for k, v in uparams0.items() if k in fixed_params}

    def objective(u_free):
        return core.objective({**u_free, **u_fixed}, data)

    B = data["X"].shape[0]
    dev = data["X"].device
    state = None
    if optimise and u_free0:
        res = minimize_lbfgs(
            objective, u_free0, max_iter=max_iter, tol_grad=tol_grad, tol_f=tol_f, memory_size=memory_size,
            linesearch=linesearch, max_linesearch_steps=max_linesearch_steps, init_state=init_state,
            return_state=return_state,
        )
        if return_state:
            res, state = res
        u_opt = {**res.params, **u_fixed}
        converged, num_iter, final_obj = res.converged, res.num_iter, res.final_value
        stalled, failed = res.stalled, res.failed
    else:
        u_opt = uparams0
        converged = torch.ones(B, dtype=torch.bool, device=dev)
        num_iter = torch.zeros(B, dtype=torch.int64, device=dev)
        with torch.no_grad():
            final_obj = (core.report_objective or core.objective)(uparams0, data)
        stalled = torch.zeros(B, dtype=torch.bool, device=dev)
        failed = torch.zeros(B, dtype=torch.bool, device=dev)

    cparams, pred = _finalize_and_predict(core, u_opt, data, Xnew, optimise)
    out = {
        "params": cparams,
        "pred": pred,
        "objective": final_obj,
        "converged": converged,
        "num_iter": num_iter,
        "stalled": stalled,
        # linesearch collapse / non-finite objective: the third exit class
        "failed": failed,
    }
    if state is not None:
        out["opt_state"] = state
    return out


def make_batched_runner(
    core: ModelCore,
    *,
    fixed_params: tuple = (),
    max_iter: int = 500,
    optimise: bool = True,
    tol_grad: Optional[float] = None,
    tol_f: Optional[float] = None,
    linesearch: Optional[str] = None,
    max_linesearch_steps: int = 32,
    memory_size: int = 10,
    mesh=None,
    device=None,
    return_state: bool = False,
    take_state: bool = False,
) -> Callable:
    """Build the batch program: (X, y, mask, Xnew, uparams0) -> results.

    Inputs are [B, ...] tensors (moved to the runner's device); results are
    tensors on that device with the JAX runner's keys: params, pred,
    objective, converged, num_iter, stalled, failed.

    fixed_params are held at their initial values; pass
    ``core.default_fixed_params`` for a core that names some (the profiled
    GPR core holds kernel_variance).

    tol_grad/tol_f default by compute dtype: 1e-6/1e-11 in f64 (scipy
    L-BFGS-B parity) but 1e-3/1e-6 in f32, whose arithmetic noise sits
    above the f64-grade thresholds. linesearch=None selects by dtype as the
    JAX engine does: "single_eval" in f32, the strong-Wolfe "zoom" in f64.
    max_linesearch_steps bounds the zoom and backtracking searches; the
    single-eval search takes one step per iteration and ignores it, as the
    JAX one does. Only the single-eval search is resumable (return_state,
    take_state).

    return_state=True adds the resumable L-BFGS state to the results
    ("opt_state", a dict of [B, ...] tensors); take_state=True makes the
    runner take such a state as a sixth argument and resume from it: the
    unconverged-lane compaction of ``run_tile_batch_carry``.

    mesh (``resolve_mesh``'s forms, with ``device``) splits each batch over
    its devices (``run_on_mesh``; a mesh of one device runs it whole);
    results land on the mesh's first device, and the runner takes only
    batches run over the same mesh (``runner.mesh``).
    """
    mesh = resolve_mesh(mesh, device)

    def run_shard(d, X, y, mask, Xnew, uparams0, state):
        f32 = X.dtype == torch.float32
        tg = tol_grad if tol_grad is not None else (1e-3 if f32 else 1e-6)
        tf = tol_f if tol_f is not None else (1e-6 if f32 else 1e-11)
        return _fit_predict_batched(
            core,
            {"X": X, "y": y, "mask": mask},
            Xnew,
            uparams0,
            fixed_params=tuple(fixed_params),
            max_iter=max_iter,
            optimise=optimise,
            tol_grad=tg,
            tol_f=tf,
            memory_size=memory_size,
            # a predict-only runner searches nothing: any line search name will do
            linesearch=resolve_linesearch(linesearch, X.dtype) if optimise else None,
            max_linesearch_steps=max_linesearch_steps,
            init_state=state,
            return_state=return_state,
        )

    def runner(X, y, mask, Xnew, uparams0, state=None):
        if take_state and state is None:
            raise TypeError("this runner was built with take_state=True: pass the carried state")
        if state is not None and not take_state:
            raise TypeError("this runner takes no state; build it with take_state=True")
        return run_on_mesh(mesh, run_shard, (X, y, mask, Xnew, dict(uparams0), state))

    runner.mesh = mesh
    return runner


_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults (eps_root 0)


def adam_update(u: dict, grads: dict, mu: dict, nu: dict, step_no: torch.Tensor, learning_rate: float):
    """One ``optax.adam(learning_rate)`` step of params {name: [B, ...]}
    with their gradients and moments; ``step_no`` [B] counts from 1 per
    lane (bias correction). Returns (params, mu, nu)."""
    bc1 = 1.0 - torch.pow(torch.full_like(step_no, _ADAM_B1), step_no)
    bc2 = 1.0 - torch.pow(torch.full_like(step_no, _ADAM_B2), step_no)
    new_u, new_mu, new_nu = {}, {}, {}
    for k, v in u.items():
        shape = (v.shape[0],) + (1,) * (v.ndim - 1)
        new_mu[k] = (1 - _ADAM_B1) * grads[k] + _ADAM_B1 * mu[k]
        new_nu[k] = (1 - _ADAM_B2) * grads[k] ** 2 + _ADAM_B2 * nu[k]
        step = (new_mu[k] / bc1.reshape(shape)) / (torch.sqrt(new_nu[k] / bc2.reshape(shape) + 0.0) + _ADAM_EPS)
        new_u[k] = v + (-learning_rate) * step
    return new_u, new_mu, new_nu


def _adam_fit_predict_batched(
    core: ModelCore,
    data: Dict[str, torch.Tensor],
    Xnew: torch.Tensor,
    uparams0: Dict[str, torch.Tensor],
    *,
    fixed_params: tuple,
    max_iter: int,
    optimise: bool,
    learning_rate: float,
    check_every: int,
    persistence: int,
):
    """All padded tiles of a batch: Adam on the free params, then predict.

    Port of ``gpsat_tpu/parallel/engine.py::_adam_fit_predict_one`` under
    vmap: every lane runs its own loop, and a lane that is done (no
    improvement of its loss for ``persistence`` iterations, checked every
    ``check_every`` from iteration 0 against a best that starts at +inf, or
    a non-finite loss) keeps its params, optimiser state and counters while
    the others run (one host sync per iteration). Adam is ``optax.adam(lr)``:
    b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias correction from
    step 1. A core with ``natgrad_update`` steps its ``natgrad_params`` by
    that hook before each Adam step and keeps them out of Adam; they still
    run when every Adam param is fixed."""
    if optimise and core.device_init is not None:
        with torch.no_grad():
            uparams0 = core.device_init(uparams0, data)
    nat_names = tuple(core.natgrad_params) if core.natgrad_update is not None else ()
    u = {k: v.detach() for k, v in uparams0.items() if k not in fixed_params and k not in nat_names}
    nat = {k: v.detach() for k, v in uparams0.items() if k in nat_names}
    u_fixed = {k: v for k, v in uparams0.items() if k in fixed_params and k not in nat_names}
    B = data["X"].shape[0]
    dev = data["X"].device

    def loss_fn(u_free, u_nat):
        return core.objective({**u_free, **u_nat, **u_fixed}, data)

    if optimise and (u or nat_names):
        mu = {k: torch.zeros_like(v) for k, v in u.items()}
        nu = {k: torch.zeros_like(v) for k, v in u.items()}
        zero_i = torch.zeros(B, dtype=torch.int64, device=dev)
        it, since_best = zero_i, zero_i
        best = torch.full((B,), float("inf"), dtype=data["X"].dtype, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        while True:
            active = (it < max_iter) & ~done
            if not bool(active.any()):
                break
            nat_new = core.natgrad_update({**u, **nat, **u_fixed}, data) if nat_names else nat
            nat_new = {k: v.detach() for k, v in nat_new.items()}
            ur = {k: v.detach().requires_grad_(True) for k, v in u.items()}
            with torch.enable_grad():
                loss = loss_fn(ur, nat_new)
                # a free param the loss never reads (the Bernoulli and Poisson
                # likelihoods' likelihood_variance) gets a zero gradient, as
                # JAX's value_and_grad gives it, and Adam leaves it in place
                grads = torch.autograd.grad(loss.sum(), list(ur.values()), allow_unused=True) if ur else ()
                grads = [torch.zeros_like(v) if g is None else g for g, v in zip(grads, ur.values())]
            loss = loss.detach()
            # Adam's step count is the lane's iteration count
            new_u, new_mu, new_nu = adam_update(u, dict(zip(u, grads)), mu, nu, (it + 1).to(best.dtype),
                                                learning_rate)
            check = torch.remainder(it, check_every) == 0
            improved = loss < best
            new_since = torch.where(check, torch.where(improved, zero_i, since_best + check_every), since_best)
            new_done = (new_since >= persistence) | ~torch.isfinite(loss)
            u = {k: _lane_where(active, new_u[k], u[k]) for k in u}
            mu = {k: _lane_where(active, new_mu[k], mu[k]) for k in mu}
            nu = {k: _lane_where(active, new_nu[k], nu[k]) for k in nu}
            nat = {k: _lane_where(active, nat_new[k], nat[k]) for k in nat}
            best = torch.where(active & check & improved, loss, best)
            since_best = torch.where(active, new_since, since_best)
            done = torch.where(active, new_done, done)
            it = torch.where(active, it + 1, it)
        with torch.no_grad():
            final_obj = loss_fn(u, nat)
        u_opt = {**u, **nat, **u_fixed}
        converged = torch.isfinite(final_obj)
        num_iter = it
    else:
        u_opt = uparams0
        with torch.no_grad():
            final_obj = (core.report_objective or core.objective)(uparams0, data)
        converged = torch.ones(B, dtype=torch.bool, device=dev)
        num_iter = torch.zeros(B, dtype=torch.int64, device=dev)

    cparams, pred = _finalize_and_predict(core, u_opt, data, Xnew, optimise)
    return {
        "params": cparams,
        "pred": pred,
        "objective": final_obj,
        "converged": converged,
        "num_iter": num_iter,
        # the persistence stop is Adam's convergence test
        "stalled": torch.zeros(B, dtype=torch.bool, device=dev),
        "failed": ~torch.isfinite(final_obj),
    }


def make_batched_adam_runner(
    core: ModelCore,
    *,
    fixed_params: tuple = (),
    max_iter: int = 2000,
    optimise: bool = True,
    learning_rate: float = 1e-2,
    check_every: int = 10,
    persistence: int = 100,
    mesh=None,
    device=None,
) -> Callable:
    """Adam counterpart of ``make_batched_runner`` for cores whose
    ``optimizer`` is "adam" (``_adam_fit_predict_batched``); the same
    (X, y, mask, Xnew, uparams0) -> results contract, result keys and
    ``mesh``."""
    mesh = resolve_mesh(mesh, device)

    def run_shard(d, X, y, mask, Xnew, uparams0):
        return _adam_fit_predict_batched(
            core,
            {"X": X, "y": y, "mask": mask},
            Xnew,
            uparams0,
            fixed_params=tuple(fixed_params),
            max_iter=max_iter,
            optimise=optimise,
            learning_rate=learning_rate,
            check_every=check_every,
            persistence=persistence,
        )

    def runner(X, y, mask, Xnew, uparams0):
        return run_on_mesh(mesh, run_shard, (X, y, mask, Xnew, dict(uparams0)))

    runner.mesh = mesh
    return runner


def make_runner_for(core: ModelCore, **kw) -> Callable:
    """The runner that ``core.optimizer`` names, built with ``kw``:
    ``make_batched_adam_runner`` for "adam", ``make_batched_runner``
    otherwise."""
    make = make_batched_adam_runner if core.optimizer == "adam" else make_batched_runner
    return make(core, **kw)


def _smart_init(batch: TileBatch) -> Dict[str, np.ndarray]:
    """Data-driven per-tile initialisation: lengthscales from the masked
    coordinate spread, variances from the observed variance."""
    m = batch.mask > 0
    Xm = np.where(m[..., None], batch.X, np.nan)
    ym = np.where(m, batch.y, np.nan)
    with np.errstate(all="ignore"):
        ls = np.nanstd(Xm, axis=1)
        var_y = np.nanvar(ym, axis=1)
    ls = np.where(np.isfinite(ls) & (ls > 0), ls, 1.0)
    var_y = np.where(np.isfinite(var_y) & (var_y > 0), var_y, 1.0)
    return {
        "lengthscales": ls.astype(batch.X.dtype),
        "kernel_variance": var_y.astype(batch.X.dtype),
        "likelihood_variance": (0.1 * var_y).astype(batch.X.dtype),
    }


def polish_tile_batch(
    batch: TileBatch,
    coarse_res: Dict[str, np.ndarray],
    core: Optional[ModelCore] = None,
    *,
    jitter: float = 0.0,
    max_iter: int = 25,
    tols: Optional[dict] = None,
    fixed_params: tuple = (),
    linesearch: str = "single_eval",
    mesh=None,
    device=None,
) -> Dict[str, np.ndarray]:
    """f64 polish of a coarse (f32) batch result.

    Re-optimises every expert in float64 from the coarse optima with a short
    single-eval L-BFGS run (tol_grad 1e-6, tol_f 1e-11 unless ``tols`` says
    otherwise), holding ``fixed_params`` and ``core.default_fixed_params``,
    then predicts in float64: the accuracy tail that brings f32 predictions
    within 1e-5 of the f64 optimum's. ``core`` defaults to
    ``make_gpr_core(jitter=jitter)``.

    It runs on the card unless ``device="cpu"``: the H100 has f64, where the
    JAX package's TPU has not (it polishes on the CPU). The kernels take f32
    only, so an f64 Gram on the card takes each factor route's library arm.

    The coarse result is aligned to the batch by ``expert_index``, not by
    row: the batch may hold dead tiles (expert_index -1, as the last split
    of a coalesced bucket does) that the coarse result has dropped. The
    result's rows follow the batch's live tiles. ``mesh`` shards the polish
    as it shards a run.
    """
    from gpsat_tpu_torch.models.functional import make_gpr_core
    from gpsat_tpu_torch.parallel.batching import cast_batch, take_batch

    if core is None:
        core = make_gpr_core(jitter=jitter)
    batch64 = cast_batch(take_batch(batch, np.flatnonzero(batch.expert_index >= 0)), np.float64)
    row_of = {int(e): i for i, e in enumerate(coarse_res["expert_index"])}
    missing = [int(e) for e in batch64.expert_index if int(e) not in row_of]
    if missing:
        raise ValueError(f"coarse result has no row for experts {missing[:8]} of the batch")
    rows = np.asarray([row_of[int(e)] for e in batch64.expert_index], dtype=np.int64)
    init = {k: np.asarray(coarse_res[k], dtype=np.float64)[rows] for k in core.param_names}
    runner = make_batched_runner(
        core,
        fixed_params=tuple(dict.fromkeys(tuple(fixed_params) + tuple(core.default_fixed_params))),
        max_iter=max_iter,
        linesearch=linesearch,
        **(tols or dict(tol_grad=1e-6, tol_f=1e-11)),
        mesh=mesh,
        device=device,
    )
    return run_tile_batch(batch64, init, runner, core, mesh=mesh, device=device)


def run_tile_batch_async(
    batch: TileBatch,
    init_cparams: Dict[str, np.ndarray],
    runner: Callable,
    core: ModelCore,
    *,
    mesh=None,
    pad_multiple: Optional[int] = None,
    device=None,
    keep_state: bool = False,
) -> Callable[[], Dict[str, np.ndarray]]:
    """Run one shape bucket; returns finalize(), which copies the results to
    the host and strips dead-tile padding.

    The L-BFGS loop syncs with the host once per iteration to test for
    remaining active lanes, so this returns after the optimisation; the
    predict may still be in flight on the device until finalize().

    init_cparams: constrained params, each either unbatched (applied to all
    experts) or with a leading [B] axis (per-expert warm starts);
    ``smart_init=True`` fills the unset ones from ``_smart_init``.

    keep_state=True (a runner built with return_state=True): finalize()
    returns ``(res, state, uparams0)``, the L-BFGS state and the
    unconstrained initial params of the live lanes, both left on the device.

    mesh: the runner's mesh (``resolve_mesh``'s forms). The bucket is padded
    to divide it (``padded_width``), the init params are prepared on the
    whole bucket before the split, and the results, in row order, land on
    the mesh's first device.
    """
    mesh = resolve_mesh(mesh, device)
    _check_runner(runner, mesh)
    dev = mesh[0]
    init_cparams = dict(init_cparams)
    if init_cparams.pop("smart_init", False):
        init_cparams = {**_smart_init(batch), **init_cparams}
    if core.prepare_batch_init is not None:
        init_cparams = core.prepare_batch_init(batch, init_cparams)

    B = batch.B
    batch = pad_batch_to(batch, padded_width(B, pad_multiple, len(mesh)))

    D = batch.X.shape[-1]
    dtype = batch.X.dtype
    defaults = core.init_cparams(D, dtype=dtype)
    cparams0 = {}
    for k, dflt in defaults.items():
        v = np.asarray(init_cparams.get(k, dflt), dtype=dtype)
        pshape = np.shape(dflt)
        if v.ndim == len(pshape) + 1 and v.shape[0] == B:
            # per-expert values for the unpadded batch: pad with defaults
            if batch.B != B:
                v = np.concatenate([v, np.broadcast_to(dflt, (batch.B - B,) + pshape)], axis=0)
        else:
            v = np.broadcast_to(v, (batch.B,) + pshape).copy()
        cparams0[k] = torch.as_tensor(v, device=dev)
    uparams0 = core.inverse(cparams0)

    # the runner moves each shard's rows from the host to its device
    out = runner(batch.X, batch.y, batch.mask, batch.Xnew, uparams0)

    def finalize():
        live = batch.expert_index >= 0

        def host(t):
            return t.detach().cpu().numpy()[live]

        res = {
            "expert_index": batch.expert_index[live],
            "num_obs": batch.num_obs[live],
            "objective": host(out["objective"]),
            "converged": host(out["converged"]),
            "num_iter": host(out["num_iter"]),
            "stalled": host(out["stalled"]),
            "failed": host(out["failed"]),
            "f_mean": host(out["pred"]["f_mean"]),
            "f_var": host(out["pred"]["f_var"]),
            "y_var": host(out["pred"]["y_var"]),
            "pred_mask": batch.pred_mask[live],
            "obs_mean": batch.obs_mean[live],
        }
        for k in core.param_names:
            res[k] = host(out["params"][k])
        if not keep_state:
            return res
        rows = torch.as_tensor(np.flatnonzero(live), device=dev)
        state = out.get("opt_state")
        state = None if state is None else {k: v[rows] for k, v in state.items()}
        return res, state, {k: v[rows] for k, v in uparams0.items()}

    return finalize


def run_tile_batch(
    batch: TileBatch,
    init_cparams: Dict[str, np.ndarray],
    runner: Callable,
    core: ModelCore,
    *,
    mesh=None,
    pad_multiple: Optional[int] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Execute one shape bucket; returns host-side arrays [B, ...]."""
    return run_tile_batch_async(
        batch, init_cparams, runner, core, mesh=mesh, pad_multiple=pad_multiple, device=device
    )()


def _live_only(batch: TileBatch, init_cparams: dict, core: ModelCore):
    """The batch without its dead tiles (expert_index -1), and the same rows
    of every per-expert init value, so both stay aligned. (The JAX package's
    carry strips the batch only, and a per-expert init then no longer fits.)"""
    live = np.flatnonzero(np.asarray(batch.expert_index) >= 0)
    if len(live) == batch.B:
        return batch, init_cparams
    defaults = core.init_cparams(batch.X.shape[-1], dtype=batch.X.dtype)
    init = dict(init_cparams)
    for k, v in init.items():
        if k in defaults:
            a = np.asarray(v)
            if a.ndim == np.ndim(defaults[k]) + 1 and a.shape[0] == batch.B:
                init[k] = a[live]
    return take_batch(batch, live), init


def _splice(head: dict, rows: np.ndarray, tail: dict, core: ModelCore) -> dict:
    """The head's results with the tail's written into ``rows``; a lane's
    iterations are its head's plus its tail's."""
    out = {k: np.array(v, copy=True) for k, v in head.items()}
    for k in ("objective", "converged", "stalled", "failed", "f_mean", "f_var", "y_var", *core.param_names):
        out[k][rows] = tail[k]
    out["num_iter"][rows] = head["num_iter"][rows] + tail["num_iter"]
    return out


def run_tile_batch_carry(
    batch: TileBatch,
    init_cparams: Dict[str, np.ndarray],
    runner_head: Callable,
    runner_tail: Callable,
    core: ModelCore,
    *,
    mesh=None,
    pad_multiple: Optional[int] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """State-carrying unconverged-lane compaction (single-eval L-BFGS).

    The head runs the whole batch for its iteration budget and returns the
    L-BFGS state; the lanes it left unconverged are gathered on the device
    (batch rows, initial params and state by one index), padded as the head
    was (power of two, or ``pad_multiple``) with dead lanes marked done so
    they exit at once, and RESUMED by the tail: no history restart, so each
    lane's iterations equal a single run's while the tail bills only the
    unconverged width. Results follow the batch's live tiles, as
    ``run_tile_batch``'s do, and add "compaction": the head's and the tail's
    padded widths, the tail's rows and each lane's head and tail iterations.

    runner_head: make_batched_runner(core, max_iter=K1, return_state=True, ...)
    runner_tail: make_batched_runner(core, max_iter=rest, take_state=True,
                 return_state=True, ...), with the head's memory_size

    Under a mesh (both runners built with it) the head runs sharded; the
    tail collects the unconverged lanes of every shard on the mesh's first
    device, pads them to divide the mesh and splits them again.
    """
    mesh = resolve_mesh(mesh, device)
    _check_runner(runner_tail, mesh)
    dev, n_dev = mesh[0], len(mesh)
    batch, init_cparams = _live_only(batch, init_cparams, core)
    res, state, uparams0 = run_tile_batch_async(
        batch, init_cparams, runner_head, core, mesh=mesh, pad_multiple=pad_multiple, keep_state=True
    )()
    unconv = np.flatnonzero(~res["converged"])
    info = {"head_width": padded_width(batch.B, pad_multiple, n_dev), "tail_width": 0, "tail_rows": unconv,
            "head_num_iter": res["num_iter"].copy(), "tail_num_iter": np.zeros(0, dtype=res["num_iter"].dtype)}
    if len(unconv) == 0 or state is None:
        return {**res, "compaction": info}

    B_sub = len(unconv)
    B_pad = padded_width(B_sub, pad_multiple, n_dev)
    sub = pad_batch_to(take_batch(batch, unconv), B_pad)
    idx = torch.as_tensor(unconv, device=dev)

    def gather(t, fill):
        t = t[idx]
        if B_pad == B_sub:
            return t
        return torch.cat([t, torch.full((B_pad - B_sub,) + tuple(t.shape[1:]), fill, dtype=t.dtype, device=dev)])

    # dead lanes: done, so they leave the loop before its first iteration
    sub_state = {k: gather(v, True if k == "done" else 0) for k, v in state.items()}
    out = runner_tail(sub.X, sub.y, sub.mask, sub.Xnew, {k: gather(v, 0) for k, v in uparams0.items()}, sub_state)

    def host(t):
        return t.detach().cpu().numpy()[:B_sub]

    tail = {k: host(out[k]) for k in ("objective", "converged", "stalled", "failed", "num_iter")}
    tail.update({k: host(out["pred"][k]) for k in ("f_mean", "f_var", "y_var")})
    tail.update({k: host(out["params"][k]) for k in core.param_names})
    info.update(tail_width=B_pad, tail_num_iter=tail["num_iter"])
    return {**_splice(res, unconv, tail, core), "compaction": info}


def run_tile_batch_two_stage(
    batch: TileBatch,
    init_cparams: Dict[str, np.ndarray],
    runner_head: Callable,
    runner_tail: Callable,
    core: ModelCore,
    *,
    mesh=None,
    pad_multiple: Optional[int] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Unconverged-lane compaction by warm restart: the whole batch runs for
    runner_head's iteration budget, then the unconverged lanes alone restart
    from the head's optima in a smaller batch with runner_tail (the L-BFGS
    history rebuilds; ``run_tile_batch_carry`` keeps it). Results follow the
    batch's live tiles and add "compaction" as the carry's do.

    runner_head: make_batched_runner(core, max_iter=K1, ...)
    runner_tail: make_batched_runner(core, max_iter=<rest>, ...)

    Under a mesh both parts run sharded, each padded to divide it.
    """
    mesh = resolve_mesh(mesh, device)
    n_dev = len(mesh)
    batch, init_cparams = _live_only(batch, init_cparams, core)
    res = run_tile_batch(batch, init_cparams, runner_head, core, mesh=mesh, pad_multiple=pad_multiple)
    unconv = np.flatnonzero(~res["converged"])
    info = {"head_width": padded_width(batch.B, pad_multiple, n_dev), "tail_width": 0, "tail_rows": unconv,
            "head_num_iter": res["num_iter"].copy(), "tail_num_iter": np.zeros(0, dtype=res["num_iter"].dtype)}
    if len(unconv) == 0:
        return {**res, "compaction": info}
    tail = run_tile_batch(
        take_batch(batch, unconv), {k: res[k][unconv] for k in core.param_names}, runner_tail, core,
        mesh=mesh, pad_multiple=pad_multiple,
    )
    info.update(tail_width=padded_width(len(unconv), pad_multiple, n_dev), tail_num_iter=tail["num_iter"])
    return {**_splice(res, unconv, tail, core), "compaction": info}
