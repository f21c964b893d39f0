"""Batched L-BFGS with per-lane convergence flags.

Port of ``gpsat_tpu/optim/lbfgs.py``: ``minimize_lbfgs`` dispatches to the
single-eval optimiser (below) or to optax's L-BFGS with its zoom or
backtracking line search (``_minimize_lbfgs_probing``, the f64 default),
written again in torch because the port imports no JAX.

The single-eval optimiser ports ``_minimize_lbfgs_single_eval``. Lanes
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

# optax 0.2.6's defaults for the probing searches, as the JAX package builds
# them (scale_by_zoom_linesearch / scale_by_backtracking_linesearch)
_ZOOM_INCREASE = 2.0
_ZOOM_SLOPE_RTOL = 1e-4
_ZOOM_CURV_RTOL = 0.9
_ZOOM_APPROX_DEC_RTOL = 1e-6
_ZOOM_INTERVAL_THRESHOLD = 1e-5  # stepsize_precision
_BT_SLOPE_RTOL = 1e-4
_BT_DECREASE = 0.8
_BT_INCREASE = 1.5
_BT_MAX_LR = 1.0
# consecutive iterations without decrease before a lane counts as stalled
_STALL_LIMIT = 4


def check_linesearch(linesearch: str) -> str:
    """``linesearch`` if it names one of ``LINESEARCHES``, else ValueError."""
    if linesearch not in LINESEARCHES:
        raise ValueError(f"linesearch: {linesearch} not in {LINESEARCHES}")
    return linesearch


def _lbfgs_direction(st: dict, x: torch.Tensor, g: torch.Tensor):
    """``optax.scale_by_lbfgs`` then ``scale(-1)``, lane by lane: the memory
    takes the newest pair (x - x_prev, g - g_prev) with weight 1 / s^T y
    (0 where s^T y == 0, no positivity test), the identity is scaled by
    s^T y / y^T y of that pair (min(1, 1 / |g|_2) on the first step), and the
    two loops run over all ``m`` slots. Returns (direction, new state)."""
    m = st["w"].shape[1]
    count = st["count"]
    first = (count == 0)[:, None]
    mem_idx = torch.remainder(count, m)
    dp = x - st["params"]
    du = g - st["updates"]
    vd = torch.sum(du * dp, -1)
    weight = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
    dp = torch.where(first, torch.zeros_like(dp), dp)
    du = torch.where(first, torch.zeros_like(du), du)
    weight = torch.where(first[:, 0], torch.zeros_like(weight), weight)
    prev_idx = torch.remainder(count - 1, m)
    dP, dU, w = _set_row(st["dP"], prev_idx, dp), _set_row(st["dU"], prev_idx, du), _set_row(st["w"], prev_idx, weight)
    den = torch.sum(du * du, -1)
    scale = torch.where(den > 0.0, torch.sum(du * dp, -1) / den, torch.ones_like(den))
    capped = torch.clamp_max(1.0 / torch.sqrt(torch.sum(g * g, -1)), 1.0)
    scale = torch.where(first[:, 0], capped, scale)

    vec, alphas = g, [None] * m
    for j in reversed(range(m)):  # newest pair first
        idx = torch.remainder(mem_idx + j, m)
        a = _rows(w, idx) * torch.sum(_rows(dP, idx) * vec, -1)
        vec = vec + (-a)[:, None] * _rows(dU, idx)
        alphas[j] = a
    vec = scale[:, None] * vec
    for j in range(m):
        idx = torch.remainder(mem_idx + j, m)
        b = _rows(w, idx) * torch.sum(_rows(dU, idx) * vec, -1)
        vec = vec + (alphas[j] - b)[:, None] * _rows(dP, idx)
    return -1.0 * vec, dict(count=count + 1, params=x, updates=g, dP=dP, dU=dU, w=w)


def _nan_to_inf(e: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(e), torch.full_like(e, float("inf")), e)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN where there is none), as optax computes it."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0, v1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc**2 * v0 + (-(db**2)) * v1) / denom
    B = ((-(dc**3)) * v0 + db**3 * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the parabola through (a, fa), (b, fb) with slope
    fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db**2)
    return a - fpa / (2.0 * B)


def _zoom_search(vg, x, u, value, grad, guess, live, max_steps: int):
    """optax 0.2.6's zoom line search (Nocedal & Wright algorithms 3.5 and
    3.6 with Hager-Zhang's approximate-Wolfe decrease), for every lane in
    lockstep: each step evaluates (f, g) at each lane's trial stepsize, and
    a lane whose search has ended (done, failed) or that is not ``live``
    keeps its state (its probe is taken at stepsize 0 and discarded). A
    failed search falls back to its safe stepsize (sufficient decrease
    without curvature), or to stepsize 0 when the last trial left the
    domain. Returns the accepted (stepsize, value, grad) per lane."""
    slope = torch.sum(u * grad, -1)
    zero = torch.zeros_like(value)
    inf = torch.full_like(value, float("inf"))
    false = torch.zeros_like(live)
    s = dict(
        count=torch.zeros_like(live, dtype=torch.int64), stepsize=zero, value=value, grad=grad, slope=slope,
        decrease_error=inf, curvature_error=inf, interval_found=false, done=false, failed=false,
        low=zero, value_low=value, slope_low=slope, high=zero, value_high=value, slope_high=slope,
        cubic_ref=zero, value_cubic_ref=value, safe_stepsize=zero, safe_value=value, safe_grad=grad,
    )
    value_init, slope_init = value, slope

    def decrease_error(t, f_t, slope_t):
        err = f_t - value_init - _ZOOM_SLOPE_RTOL * t * slope_init
        approx = slope_t - (2 * _ZOOM_SLOPE_RTOL - 1.0) * slope_init
        delta = f_t - value_init - _ZOOM_APPROX_DEC_RTOL * torch.abs(value_init)
        err = torch.minimum(torch.maximum(approx, delta), err)
        return _nan_to_inf(torch.clamp_min(err, 0.0))

    while True:
        act = live & ~(s["done"] | s["failed"])
        if not bool(act.any()):
            break
        found = s["interval_found"]
        # the interval search's next trial: the guess, then doubling
        t_search = torch.where(s["count"] == 0, guess, _ZOOM_INCREASE * s["stepsize"])
        # the zoom's next trial: cubic, else quadratic, else bisection
        low, vl, sl, high, vh, sh = (s[k] for k in ("low", "value_low", "slope_low", "high", "value_high",
                                                    "slope_high"))
        cref, vcref = s["cubic_ref"], s["value_cubic_ref"]
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        mc = _cubicmin(low, vl, sl, high, vh, cref, vcref)
        use_cubic = (mc > left + 0.2 * delta) & (mc < right - 0.2 * delta)
        mq = _quadmin(low, vl, sl, high, vh)
        use_quad = ~use_cubic & (mq > left + 0.1 * delta) & (mq < right - 0.1 * delta)
        middle = torch.where(use_cubic, mc, cref)
        middle = torch.where(use_quad, mq, middle)
        middle = torch.where(~use_cubic & ~use_quad, (low + high) / 2.0, middle)
        t = torch.where(found, middle, t_search)

        f_t, g_t = vg(x + torch.where(act, t, zero)[:, None] * u)
        slope_t = torch.sum(g_t * u, -1)
        de = decrease_error(t, f_t, slope_t)
        ce = _nan_to_inf(torch.clamp_min(torch.abs(slope_t) - _ZOOM_CURV_RTOL * torch.abs(slope_init), 0.0))
        err = torch.maximum(de, ce)
        done = err <= 0.0
        last = s["count"] + 1 >= max_steps

        # interval search (algorithm 3.5)
        sh_new = (de > 0.0) | ((f_t >= s["value"]) & (s["count"] > 0))
        sl_new = (slope_t >= 0.0) & ~sh_new
        srch = dict(
            low=torch.where(sl_new, t, s["stepsize"]), value_low=torch.where(sl_new, f_t, s["value"]),
            slope_low=torch.where(sl_new, slope_t, s["slope"]), high=torch.where(sl_new, s["stepsize"], t),
            value_high=torch.where(sl_new, s["value"], f_t), slope_high=torch.where(sl_new, s["slope"], slope_t),
            interval_found=sh_new | sl_new | done,
        )
        srch.update(cubic_ref=srch["low"], value_cubic_ref=srch["value_low"])
        safe_srch = de <= 0.0
        # zoom (algorithm 3.6)
        safe_zoom = (de <= 0.0) & (f_t < s["safe_value"])
        shm = (de > 0.0) | (f_t >= vl)
        shl = (slope_t * (high - low) >= 0.0) & ~shm
        nh = torch.where(shl, low, torch.where(shm, t, high))
        nvh = torch.where(shl, vl, torch.where(shm, f_t, vh))
        nsh = torch.where(shl, sl, torch.where(shm, slope_t, sh))
        moved_high = shm | shl
        zoom = dict(
            low=torch.where(shm, low, t), value_low=torch.where(shm, vl, f_t), slope_low=torch.where(shm, sl, slope_t),
            high=nh, value_high=nvh, slope_high=nsh, interval_found=found,
            cubic_ref=torch.where(moved_high, high, low), value_cubic_ref=torch.where(moved_high, vh, vl),
        )
        take_safe = torch.where(found, safe_zoom, safe_srch)
        new = {k: torch.where(found, zoom[k], srch[k]) for k in zoom}
        new.update(
            count=s["count"] + 1, stepsize=t, value=f_t, grad=g_t, slope=slope_t, decrease_error=de,
            curvature_error=ce, done=done,
            safe_stepsize=torch.where(take_safe, t, s["safe_stepsize"]),
            safe_value=torch.where(take_safe, f_t, s["safe_value"]),
            safe_grad=torch.where(take_safe[:, None], g_t, s["safe_grad"]),
        )
        too_small = torch.abs(high - low) <= _ZOOM_INTERVAL_THRESHOLD
        new["failed"] = torch.where(found, last | (too_small & (new["safe_stepsize"] > 0.0)), last) & ~done
        # a failed search takes its safe step, or stays put outside the domain
        fall = new["failed"] & ((new["safe_stepsize"] > 0.0) | torch.isinf(de))
        new["stepsize"] = torch.where(fall, new["safe_stepsize"], t)
        new["value"] = torch.where(fall, new["safe_value"], f_t)
        new["grad"] = torch.where(fall[:, None], new["safe_grad"], g_t)
        s = {k: _lane_where(act, new[k], s[k]) for k in s}
    return s["stepsize"], s["value"], s["grad"]


def _backtracking_search(f_only, x, u, value, grad, lr_prev, live, max_steps: int):
    """optax 0.2.6's backtracking (Armijo) search with value-only probes
    (``store_grad=False``), for every lane in lockstep: the first trial is
    min(1.5 lr_prev, 1), then 0.8 times the last, for at most
    ``max_steps`` + 1 trials; a search that ends on a non-finite value
    takes stepsize 0. Returns the stepsize per lane."""
    slope = torch.sum(u * grad, -1)
    lr = torch.clamp_max(_BT_INCREASE * lr_prev, _BT_MAX_LR)
    de = torch.full_like(value, float("inf"))
    it = torch.zeros_like(live, dtype=torch.int64)
    while True:
        act = live & ~(de <= 0.0) & (it <= max_steps)
        if not bool(act.any()):
            break
        lr_t = torch.where(it > 0, _BT_DECREASE * lr, lr)
        f_t = f_only(x + torch.where(act, lr_t, torch.zeros_like(lr_t))[:, None] * u)
        e = torch.clamp_min(_nan_to_inf(f_t - 1.0 * value - lr_t * _BT_SLOPE_RTOL * slope), 0.0)
        lr, de, it = torch.where(act, lr_t, lr), torch.where(act, e, de), torch.where(act, it + 1, it)
    return torch.where(torch.isinf(de), torch.zeros_like(lr), lr)


def _minimize_lbfgs_probing(fun, x0: dict, *, max_iter: int, tol_grad: float, tol_f: float, memory_size: int,
                            max_linesearch_steps: int, linesearch: str) -> LBFGSResult:
    """The JAX package's loop around ``optax.lbfgs`` with the zoom or backtracking
    search (``gpsat_tpu/optim/lbfgs.py::minimize_lbfgs``), batched over
    lanes: a lane iterates while (it < max_iter) and it is not done, failed
    or stalled (``_STALL_LIMIT`` iterations in a row without decrease);
    every other lane is frozen.

    Zoom caches the accepted point's (f, g) for the next iteration and tests
    convergence on it; a zero decrease counts as converged there. The
    backtracking loop evaluates (f, g) at the iterate each iteration and
    tests convergence on those, one iteration behind the iterate, with the
    first previous value +inf and only a strictly positive decrease counting.
    A lane whose new value is not finite keeps its previous iterate and
    stops as failed."""
    x, unravel = ravel({k: v.detach() for k, v in x0.items()})
    B, dim = x.shape
    m = memory_size
    dt, dev = x.dtype, x.device
    zoom = linesearch == "zoom"

    def vg(xf):
        xr = xf.detach().requires_grad_(True)
        with torch.enable_grad():
            f = fun(unravel(xr))
            (g,) = torch.autograd.grad(f.sum(), xr)
        return f.detach(), g

    def f_only(xf):
        with torch.no_grad():
            return fun(unravel(xf)).detach()

    v0 = f_only(x)
    zero_i = torch.zeros(B, dtype=torch.int64, device=dev)
    lb = dict(count=zero_i, params=torch.zeros_like(x), updates=torch.zeros_like(x),
              dP=torch.zeros(B, m, dim, dtype=dt, device=dev), dU=torch.zeros(B, m, dim, dtype=dt, device=dev),
              w=torch.zeros(B, m, dtype=dt, device=dev))
    c = dict(
        x=x, lr=torch.ones(B, dtype=dt, device=dev),
        # zoom's cached (f, g) at the iterate; +inf: evaluate
        cval=torch.full((B,), float("inf"), dtype=dt, device=dev), cgrad=torch.zeros_like(x),
        prev=v0 if zoom else torch.full((B,), float("inf"), dtype=dt, device=dev),
        done=torch.zeros(B, dtype=torch.bool, device=dev), failed=~torch.isfinite(v0), stall=zero_i, it=zero_i,
        **{"lb_" + k: v for k, v in lb.items()},
    )
    one = torch.ones((), dtype=dt, device=dev)

    while True:
        active = (c["it"] < max_iter) & ~(c["done"] | c["failed"]) & (c["stall"] < _STALL_LIMIT)
        if not bool(active.any()):
            break
        if zoom:
            fresh = ~torch.isfinite(c["cval"])
            value, grad = c["cval"], c["cgrad"]
            if bool((active & fresh).any()):
                fv, gv = vg(c["x"])
                value, grad = torch.where(fresh, fv, value), torch.where(fresh[:, None], gv, grad)
        else:
            value, grad = vg(c["x"])
        u, lb = _lbfgs_direction({k: c["lb_" + k] for k in lb}, c["x"], grad)
        if zoom:
            lr, new_val, new_grad = _zoom_search(vg, c["x"], u, value, grad, c["lr"], active, max_linesearch_steps)
        else:
            lr = _backtracking_search(f_only, c["x"], u, value, grad, c["lr"], active, max_linesearch_steps)
            new_val, new_grad = value, grad
        new_x = c["x"] + lr[:, None] * u
        gnorm = torch.amax(torch.abs(new_grad), -1)
        decrease = c["prev"] - new_val
        min_ok = decrease >= 0 if zoom else decrease > 0
        f_small = min_ok & (decrease <= tol_f * torch.maximum(torch.abs(new_val), one))
        done = (gnorm <= tol_grad) | f_small
        failed = ~torch.isfinite(new_val)
        new = dict(
            x=torch.where(failed[:, None], c["x"], new_x), lr=lr, cval=new_val, cgrad=new_grad, prev=new_val,
            done=done, failed=failed, stall=torch.where((decrease > 0) | done, zero_i, c["stall"] + 1),
            it=c["it"] + 1, **{"lb_" + k: v for k, v in lb.items()},
        )
        c = {k: _lane_where(active, new[k], c[k]) for k in c}

    grad = c["cgrad"] if zoom else vg(c["x"])[1]
    return LBFGSResult(
        params=unravel(c["x"]),
        converged=c["done"] & ~c["failed"],
        failed=c["failed"],
        num_iter=c["it"],
        final_value=c["prev"],
        final_grad_norm=torch.amax(torch.abs(grad), -1),
        stalled=(c["stall"] >= _STALL_LIMIT) & ~c["done"],
    )


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
    (one trial per iteration) as the JAX package's does; "zoom" (the f64
    default) and "backtracking" run optax's L-BFGS with that search
    (``_minimize_lbfgs_probing``). Only "single_eval" is resumable: the
    others raise ValueError for ``init_state`` or ``return_state``."""
    check_linesearch(linesearch)
    if linesearch == "single_eval":
        return minimize_lbfgs_single_eval(
            fun, x0, max_iter=max_iter, tol_grad=tol_grad, tol_f=tol_f, memory_size=memory_size,
            init_state=init_state, return_state=return_state,
        )
    if init_state is not None or return_state:
        raise ValueError("resumable state (init_state / return_state) is only supported for linesearch='single_eval'")
    return _minimize_lbfgs_probing(
        fun, x0, max_iter=max_iter, tol_grad=tol_grad, tol_f=tol_f, memory_size=memory_size,
        max_linesearch_steps=max_linesearch_steps, linesearch=linesearch,
    )
