"""Batched single-eval L-BFGS with per-lane convergence flags.

Port of ``gpsat_tpu/optim/lbfgs.py::_minimize_lbfgs_single_eval``. Lanes
(experts) are the leading dimension of every state tensor. The loop keeps
the lockstep semantics of JAX's batched ``while_loop``: every iteration
computes the body for all lanes, and a lane's carry takes the new values
only while it is active, ``(it < max_iter) & ~done & ~failed``. The loop
ends when no lane is active (one host sync per iteration).

Each iteration makes exactly ONE value-and-gradient evaluation: the trial
point's own (f, g) decides acceptance (monotone Armijo, the JAX driver's
default nonmonotone_window=1); on rejection the step
shrinks by quadratic interpolation and the history is not updated.
Curvature pairs are pushed only when s^T y > 0. No operation mixes lanes,
so one lane's NaN never reaches another.

Convergence: max|grad| <= tol_grad, or an accepted step with
|f_prev - f| <= tol_f * max(|f|, 1), or the rejected-tie stall guard.

The optimiser is resumable (``init_state`` / ``return_state``): the state is a
dict of [B, ...] tensors (iterate, curvature history, step, exit flags), so
a run stopped at its iteration budget continues in a later call with its
history intact. The unconverged-lane compaction of ``parallel.engine``
resumes a gathered subset of lanes this way.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

_C1 = 1e-4  # Armijo sufficient-decrease constant
_SHRINK = 0.3  # step factor when the interpolated step is not finite


class LBFGSResult(NamedTuple):
    params: dict
    converged: torch.Tensor  # bool [B]
    failed: torch.Tensor  # bool [B] — non-finite objective or step collapse
    num_iter: torch.Tensor  # int [B]
    final_value: torch.Tensor  # [B]
    final_grad_norm: torch.Tensor  # [B]
    # exit reason was the stall guard (flat-optimum straggler), not a
    # gradient/factr tolerance
    stalled: torch.Tensor  # bool [B]


def ravel(params: dict):
    """{name: [B, ...]} -> ([B, dim], unravel), in sorted-key order (the
    order of ``jax.flatten_util.ravel_pytree`` on a dict)."""
    keys = sorted(params)
    B = next(iter(params.values())).shape[0]
    shapes = [tuple(params[k].shape[1:]) for k in keys]
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    flat = torch.cat([params[k].reshape(B, -1) for k in keys], dim=1)

    def unravel(xf):
        out, o = {}, 0
        for k, s, n in zip(keys, shapes, sizes):
            out[k] = xf[:, o : o + n].reshape((xf.shape[0],) + s)
            o += n
        return out

    return flat, unravel


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[b, idx[b]] for every lane b."""
    return t[torch.arange(t.shape[0], device=t.device), idx]


def _two_loop(g, S, Y, rho, count, m):
    """Standard two-loop recursion over each lane's circular history."""
    B = g.shape[0]
    q = g
    alphas = []
    for i in range(m):
        idx = torch.remainder(count - 1 - i, m)
        valid = i < torch.clamp_max(count, m)
        a = torch.where(valid, _rows(rho, idx) * torch.sum(_rows(S, idx) * q, -1), torch.zeros_like(q[:, 0]))
        q = q - a[:, None] * _rows(Y, idx) * valid.to(q.dtype)[:, None]
        alphas.append(a)
    # initial scaling gamma = s^T y / y^T y of the newest pair
    newest = torch.remainder(count - 1, m)
    Yn, Sn = _rows(Y, newest), _rows(S, newest)
    ynorm2 = torch.sum(Yn * Yn, -1)
    gamma = torch.where(
        (count > 0) & (ynorm2 > 0),
        torch.sum(Sn * Yn, -1) / torch.clamp_min(ynorm2, 1e-30),
        torch.ones_like(ynorm2),
    )
    r = q * gamma[:, None]
    for i in range(m):
        j = m - 1 - i
        idx = torch.remainder(count - 1 - j, m)
        valid = j < torch.clamp_max(count, m)
        b = torch.where(valid, _rows(rho, idx) * torch.sum(_rows(Y, idx) * r, -1), torch.zeros(B, dtype=r.dtype, device=r.device))
        r = r + (alphas[j] - b)[:, None] * _rows(S, idx) * valid.to(r.dtype)[:, None]
    return r


def _set_row(t: torch.Tensor, idx: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    out = t.clone()
    out[torch.arange(t.shape[0], device=t.device), idx] = row
    return out


def _lane_where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - 1)), a, b)


# the carry that a resumed call takes and a returning call gives
STATE_KEYS = ("x", "S", "Y", "rho", "count", "step", "done", "failed", "stalled")


def minimize_lbfgs_single_eval(
    fun: Callable,
    x0: dict,
    *,
    max_iter: int,
    tol_grad: float,
    tol_f: float,
    memory_size: int = 10,
    init_state: Optional[dict] = None,
    return_state: bool = False,
):
    """Minimise ``fun(params) -> [B]`` lane by lane.

    x0: {name: [B, ...]} initial (unconstrained) parameters. ``fun`` must
    keep lanes independent; the gradient of ``fun(x).sum()`` is then each
    lane's own gradient.

    init_state: a state returned by an earlier call (``STATE_KEYS``, each
    [B, ...]); the run resumes from its iterate and history instead of x0,
    whose values then give only the shapes. The resumed call evaluates
    (f, g) at the carried iterate itself rather than trusting a carried f:
    two programs round differently, and a carried f below this call's own
    surface would make every trial look uphill. Its iteration count starts
    at 0; the carried done / failed flags stay set, and stalled is kept.
    return_state: also return the final state, ``(result, state)``.
    """
    x0_flat, unravel = ravel({k: v.detach() for k, v in x0.items()})
    B, dim = x0_flat.shape
    m = memory_size
    dt, dev = x0_flat.dtype, x0_flat.device

    def vg(xf):
        xr = xf.detach().requires_grad_(True)
        with torch.enable_grad():
            f = fun(unravel(xr))
            (g,) = torch.autograd.grad(f.sum(), xr)
        return f.detach(), g

    zero_i = torch.zeros(B, dtype=torch.int64, device=dev)
    if init_state is None:
        f0, g0 = vg(x0_flat)
        c = dict(
            x=x0_flat,
            f=f0,
            g=g0,
            S=torch.zeros(B, m, dim, dtype=dt, device=dev),
            Y=torch.zeros(B, m, dim, dtype=dt, device=dev),
            rho=torch.zeros(B, m, dtype=dt, device=dev),
            count=zero_i,
            step=torch.ones(B, dtype=dt, device=dev),
            it=zero_i,
            # already-converged starts must exit immediately
            done=torch.amax(torch.abs(g0), -1) <= tol_grad,
            failed=~torch.isfinite(f0),
            stalled=torch.zeros(B, dtype=torch.bool, device=dev),
        )
    else:
        if init_state["S"].shape[1:] != (m, dim):
            raise ValueError(f"carried history {tuple(init_state['S'].shape)} does not fit memory_size {m}, dim {dim}")
        # resume: fresh budget, (f, g) re-anchored on this call's own surface
        f0, g0 = vg(init_state["x"])
        c = {k: init_state[k] for k in STATE_KEYS}
        c.update(
            f=f0,
            g=g0,
            it=zero_i,
            done=init_state["done"] | (torch.amax(torch.abs(g0), -1) <= tol_grad),
            failed=init_state["failed"] | ~torch.isfinite(f0),
        )
    one = torch.ones((), dtype=dt, device=dev)

    while True:
        active = (c["it"] < max_iter) & ~(c["done"] | c["failed"])
        if not bool(active.any()):
            break

        d = -_two_loop(c["g"], c["S"], c["Y"], c["rho"], c["count"], m)
        # no curvature history yet: steepest descent normalised to unit length
        d = torch.where((c["count"] > 0)[:, None], d, d / torch.maximum(torch.linalg.vector_norm(d, dim=-1), one)[:, None])
        gTd = torch.sum(c["g"] * d, -1)
        # safeguard: fall back to steepest descent on non-descent directions
        desc = gTd < 0
        d = torch.where(desc[:, None], d, -c["g"])
        gTd = torch.where(desc, gTd, -torch.sum(c["g"] * c["g"], -1))

        trial = c["x"] + c["step"][:, None] * d
        f_t, g_t = vg(trial)
        accept = torch.isfinite(f_t) & (f_t <= c["f"] + _C1 * c["step"] * gTd)

        s = trial - c["x"]
        yv = g_t - c["g"]
        sty = torch.sum(s * yv, -1)
        push = accept & (sty > 1e-12)
        idx = torch.remainder(c["count"], m)
        S = _lane_where(push, _set_row(c["S"], idx, s), c["S"])
        Y = _lane_where(push, _set_row(c["Y"], idx, yv), c["Y"])
        rho = _lane_where(push, _set_row(c["rho"], idx, 1.0 / torch.clamp_min(sty, 1e-30)), c["rho"])
        count = torch.where(push, c["count"] + 1, c["count"])

        x = torch.where(accept[:, None], trial, c["x"])
        f_new = torch.where(accept, f_t, c["f"])
        g_new = torch.where(accept[:, None], g_t, c["g"])
        # on rejection: minimiser of the parabola through (f, gTd, f_t),
        # clamped to [0.1, 0.5] * step; on acceptance grow the step gradually
        denom = f_t - c["f"] - gTd * c["step"]
        quad = -0.5 * gTd * c["step"] ** 2 / torch.where(torch.abs(denom) > 1e-30, denom, torch.full_like(denom, 1e-30))
        quad = torch.where(torch.isfinite(quad), quad, _SHRINK * c["step"])
        shrunk = torch.minimum(torch.maximum(quad, 0.1 * c["step"]), 0.5 * c["step"])
        step = torch.where(accept, torch.minimum(one, c["step"] * 2.0), shrunk)

        gnorm = torch.amax(torch.abs(g_new), -1)
        f_resolve = torch.abs(c["f"] - f_t) <= tol_f * torch.maximum(torch.abs(f_t), one)
        f_small = accept & f_resolve
        # a rejected trial indistinguishable from the current value at an
        # already-small step: the objective cannot be resolved further
        stuck_done = ~accept & torch.isfinite(f_t) & f_resolve & (c["step"] <= 1e-2)
        done = (gnorm <= tol_grad) | f_small | stuck_done
        failed = (c["step"] < 1e-12) | ~torch.isfinite(f_new)
        stalled = stuck_done & ~((gnorm <= tol_grad) | f_small)

        new = dict(x=x, f=f_new, g=g_new, S=S, Y=Y, rho=rho, count=count, step=step, it=c["it"] + 1, done=done, failed=failed, stalled=stalled)
        c = {k: _lane_where(active, new[k], c[k]) for k in c}

    res = LBFGSResult(
        params=unravel(c["x"]),
        converged=c["done"] & ~c["failed"],
        failed=c["failed"],
        num_iter=c["it"],
        final_value=c["f"],
        final_grad_norm=torch.amax(torch.abs(c["g"]), -1),
        stalled=c["stalled"],
    )
    return (res, {k: c[k] for k in STATE_KEYS}) if return_state else res


LINESEARCHES = ("zoom", "backtracking", "single_eval")


def check_linesearch(linesearch: str) -> str:
    """``linesearch`` if the port runs it: only "single_eval" is ported;
    "zoom" and "backtracking" raise NotImplementedError, other names
    ValueError."""
    if linesearch not in LINESEARCHES:
        raise ValueError(f"linesearch: {linesearch} not in {LINESEARCHES}")
    if linesearch != "single_eval":
        raise NotImplementedError(
            f"linesearch={linesearch!r} is not ported; use 'single_eval' (see ROADMAP.md Queue 1 item 5)"
        )
    return linesearch


def minimize_lbfgs(
    fun: Callable,
    x0: dict,
    *,
    max_iter: int = 500,
    tol_grad: float = 1e-6,
    tol_f: float = 1e-11,
    memory_size: int = 10,
    max_linesearch_steps: int = 32,
    linesearch: str = "zoom",
    init_state: Optional[dict] = None,
    return_state: bool = False,
):
    """The JAX package's L-BFGS entry point (``gpsat_tpu/optim/lbfgs.py::
    minimize_lbfgs``): dispatches on ``linesearch``. "single_eval" runs
    ``minimize_lbfgs_single_eval``, which ignores ``max_linesearch_steps``
    (one trial per iteration) as the JAX package's does."""
    check_linesearch(linesearch)
    return minimize_lbfgs_single_eval(
        fun, x0, max_iter=max_iter, tol_grad=tol_grad, tol_f=tol_f, memory_size=memory_size,
        init_state=init_state, return_state=return_state,
    )
