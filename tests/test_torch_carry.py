"""The port's resumable L-BFGS and unconverged-lane compaction
(gpsat_tpu_torch/optim/lbfgs.py, parallel/engine.py::run_tile_batch_carry /
run_tile_batch_two_stage, the sweep's carry_iters / two_stage_iters) against
a single run of the port and against the JAX engine, in f64 on the CPU.

Two JAX programs are compiled: a head runner that returns the L-BFGS state
and a tail runner that resumes it. The JAX two-stage run takes the head
runner for both of its stages."""

import numpy as np
import pytest
import torch

from gpsat_tpu.models.functional import make_gpr_core as jax_make_gpr_core
from gpsat_tpu.ops import linalg as JLA
from gpsat_tpu.parallel import engine as JE
from gpsat_tpu_torch.convert import batch_from_numpy
from gpsat_tpu_torch.models.functional import make_gpr_core
from gpsat_tpu_torch.optim import lbfgs as TL
from gpsat_tpu_torch.parallel import engine as TE
from gpsat_tpu_torch.parallel.batching import TileBatch, pad_batch_to

B, N, P, D = 8, 64, 8, 2
HEAD_ITERS = 3  # no lane converges this early: the tail has the head's width
TOLS = dict(tol_grad=1e-6, tol_f=1e-11)
INIT = {"likelihood_variance": 0.1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under the tier-1 run's six pytest workers torch's
    default of one thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-6, 6, (B, N, D))
    y = np.sin(X[..., 0]) * np.cos(X[..., 1]) + 0.1 * rng.normal(size=(B, N))
    mask = np.ones((B, N))
    fill = rng.integers(int(0.6 * N), N + 1, size=B)
    for i, f in enumerate(fill):
        mask[i, f:] = 0.0
    return TileBatch(
        X=X, y=y, mask=mask, Xnew=rng.uniform(-4, 4, (B, P, D)), pred_mask=np.ones((B, P)),
        obs_mean=np.zeros(B), expert_index=np.arange(B), num_obs=fill,
    )


def _runners(core, head_iters=HEAD_ITERS, **kw):
    kw = dict(linesearch="single_eval", device="cpu", **TOLS, **kw)
    head = TE.make_batched_runner(core, max_iter=head_iters, return_state=True, **kw)
    tail = TE.make_batched_runner(core, max_iter=400, take_state=True, return_state=True, **kw)
    return head, tail


@pytest.fixture(scope="module")
def single():
    """The port's single run of the batch, the gold of the exact tests."""
    core = make_gpr_core()
    full = TE.make_batched_runner(core, max_iter=400, linesearch="single_eval", device="cpu", **TOLS)
    res = TE.run_tile_batch(_batch(), INIT, full, core, device="cpu")
    assert res["converged"].all() and (res["num_iter"] > HEAD_ITERS).all()
    return res


def _assert_exact(got, gold):
    np.testing.assert_array_equal(got["num_iter"], gold["num_iter"])
    np.testing.assert_allclose(got["objective"], gold["objective"], rtol=1e-12)
    np.testing.assert_allclose(got["f_mean"], gold["f_mean"], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got["f_var"], gold["f_var"], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got["lengthscales"], gold["lengthscales"], rtol=1e-12)


@pytest.mark.parametrize("pad_multiple", [None, 6])
def test_carry_equals_the_single_run_exactly(single, pad_multiple):
    """Head + resumed tail = one run: the state round-trips with no history
    restart, so every lane takes the same iterations to the same optimum."""
    core = make_gpr_core()
    head, tail = _runners(core)
    got = TE.run_tile_batch_carry(_batch(), INIT, head, tail, core, pad_multiple=pad_multiple, device="cpu")
    _assert_exact(got, single)
    info = got["compaction"]
    assert info["tail_width"] == (8 if pad_multiple is None else 12) and len(info["tail_rows"]) == B
    np.testing.assert_array_equal(info["head_num_iter"], HEAD_ITERS)
    np.testing.assert_array_equal(info["head_num_iter"] + info["tail_num_iter"], single["num_iter"])


def test_resumed_lbfgs_equals_one_call():
    """minimize_lbfgs_single_eval stopped and resumed through its state
    takes the iterations of one call, on a batch of Rosenbrock lanes."""

    scale = torch.tensor([1.0, 2.0, 0.5], dtype=torch.float64)

    def rosen(p):
        x = p["x"]
        return ((1 - x[:, 0]) ** 2 + 100 * (x[:, 1] - x[:, 0] ** 2) ** 2) * scale

    x0 = {"x": torch.tensor([[-1.2, 1.0], [0.5, -0.3], [2.0, 2.0]], dtype=torch.float64)}
    kw = dict(tol_grad=1e-8, tol_f=0.0, memory_size=5)
    one = TL.minimize_lbfgs(rosen, x0, max_iter=500, linesearch="single_eval", **kw)
    assert one.converged.all()
    head, state = TL.minimize_lbfgs_single_eval(rosen, x0, max_iter=7, return_state=True, **kw)
    assert set(state) == set(TL.STATE_KEYS) and state["done"].dtype == torch.bool
    tail = TL.minimize_lbfgs(rosen, x0, max_iter=500, linesearch="single_eval", init_state=state, **kw)
    assert torch.equal(head.num_iter + tail.num_iter, one.num_iter)
    assert torch.equal(tail.params["x"], one.params["x"])
    with pytest.raises(ValueError, match="memory_size"):
        TL.minimize_lbfgs_single_eval(rosen, x0, max_iter=5, init_state=state, tol_grad=1e-8, tol_f=0.0, memory_size=3)


@pytest.mark.parametrize("linesearch, kw, match", [
    # the probing searches run, but only the single-eval one is resumable
    ("zoom", {"return_state": True}, "only supported for linesearch='single_eval'"),
    ("backtracking", {"init_state": {}}, "only supported for linesearch='single_eval'"),
    ("wolfe", {}, "not in"),
])
def test_minimize_lbfgs_dispatch_refuses_unported_searches(linesearch, kw, match):
    x0 = {"x": torch.zeros(2, 1, dtype=torch.float64)}
    with pytest.raises(ValueError, match=match):
        TL.minimize_lbfgs(lambda p: (p["x"][:, 0] - 1) ** 2, x0, linesearch=linesearch, **kw)


def test_no_lane_left_after_the_head_skips_the_tail(single):
    core = make_gpr_core()
    head, _ = _runners(core, head_iters=400)

    def tail(*args):
        raise AssertionError("the tail ran with every lane converged")

    tail.mesh = head.mesh
    got = TE.run_tile_batch_carry(_batch(), INIT, head, tail, core, device="cpu")
    _assert_exact(got, single)
    assert got["compaction"]["tail_width"] == 0 and len(got["compaction"]["tail_rows"]) == 0


def test_dead_lanes_of_the_tail_exit_at_once(single):
    """Padding the compacted lanes to pad_multiple adds dead lanes marked
    done: they run no iteration and keep their bool flags bool."""
    core = make_gpr_core()
    head, tail = _runners(core, head_iters=int(np.sort(single["num_iter"])[B - 3]))
    seen = {}

    def spy(X, y, mask, Xnew, u0, state):
        seen.update(done=state["done"].clone(), failed=state["failed"].clone())
        out = tail(X, y, mask, Xnew, u0, state)
        seen["num_iter"] = out["num_iter"].clone()
        return out

    spy.mesh = tail.mesh
    got = TE.run_tile_batch_carry(_batch(), INIT, head, spy, core, pad_multiple=8, device="cpu")
    _assert_exact(got, single)
    n = len(got["compaction"]["tail_rows"])
    assert 0 < n < 8 and seen["num_iter"].shape == (8,)
    assert seen["done"].dtype == torch.bool and seen["failed"].dtype == torch.bool
    assert seen["done"][n:].all() and not seen["done"][:n].any()
    assert (seen["num_iter"][n:] == 0).all() and (seen["num_iter"][:n] > 0).all()


@pytest.mark.parametrize("how", ["carry", "two_stage"])
def test_per_expert_init_with_dead_tiles_stays_aligned(how):
    """A batch padded with dead tiles and a per-expert init of its padded
    width gives the results of the unpadded batch with the live rows of the
    init: the compaction strips the same rows of both (the JAX package's
    carry strips the batch only, and its init then no longer fits)."""
    core = make_gpr_core()
    if how == "carry":
        head, tail = _runners(core)
    else:
        head = TE.make_batched_runner(core, max_iter=HEAD_ITERS, linesearch="single_eval", device="cpu", **TOLS)
        tail = TE.make_batched_runner(core, max_iter=400, linesearch="single_eval", device="cpu", **TOLS)
    run = TE.run_tile_batch_carry if how == "carry" else TE.run_tile_batch_two_stage
    live_init = np.linspace(0.05, 0.2, B)
    gold = run(_batch(), {"likelihood_variance": live_init}, head, tail, core, device="cpu")
    got = run(pad_batch_to(_batch(), 11), {"likelihood_variance": np.r_[live_init, [9.0, 9.0, 9.0]]}, head, tail,
              core, device="cpu")
    np.testing.assert_array_equal(got["expert_index"], np.arange(B))
    _assert_exact(got, gold)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's carry and two-stage runs of the batch: two runner programs."""
    batch = _batch()
    JLA.set_fast_inverse(True)
    try:
        core = jax_make_gpr_core()
        kw = dict(linesearch="single_eval", **TOLS)
        head = JE.make_batched_runner(core, max_iter=HEAD_ITERS, return_state=True, **kw)
        tail = JE.make_batched_runner(core, max_iter=400, take_state=True, return_state=True, **kw)
        carry = JE.run_tile_batch_carry(batch, INIT, head, tail, core)
        two = JE.run_tile_batch_two_stage(batch, INIT, head, head, core)
    finally:
        JLA.set_fast_inverse(None)
    return {"carry": carry, "two_stage": two}


def _assert_jax_bands(got, ref):
    """The bands of tests/test_torch_engine.py::test_slice_f64_matches_jax_engine."""
    np.testing.assert_array_equal(got["expert_index"], ref["expert_index"])
    np.testing.assert_array_equal(got["converged"], ref["converged"])
    same = got["num_iter"] == ref["num_iter"]
    assert same.sum() >= B - 1, (got["num_iter"], ref["num_iter"])
    for k in ("lengthscales", "kernel_variance", "likelihood_variance"):
        rel = (np.abs(got[k] - ref[k]) / np.maximum(np.abs(ref[k]), 1e-6)).reshape(B, -1).max(1)
        assert rel[same].max() <= 1e-6 and rel.max() <= 1e-5, (k, rel)
    for k in ("f_mean", "f_var", "y_var"):
        err = np.abs(got[k] - ref[k]).max(1)
        assert err[same].max() <= 1e-8 and err.max() <= 1e-6, (k, err)
    np.testing.assert_allclose(got["objective"], ref["objective"], rtol=1e-10)


@pytest.mark.parametrize("how", ["carry", "two_stage"])
def test_compaction_matches_jax(jax_runs, how):
    core = make_gpr_core()
    head, tail = _runners(core)
    batch = batch_from_numpy(_batch())
    if how == "carry":
        got = TE.run_tile_batch_carry(batch, INIT, head, tail, core, device="cpu")
    else:
        got = TE.run_tile_batch_two_stage(batch, INIT, head, head, core, device="cpu")
    _assert_jax_bands(got, jax_runs[how])


def _sweep_inputs():
    rng = np.random.default_rng(5)
    n = 400
    obs = {"x": rng.uniform(0, 10, n), "y": rng.uniform(0, 10, n)}
    obs["z"] = np.sin(obs["x"]) * np.cos(obs["y"]) + 0.1 * rng.normal(size=n)
    experts = {"x": np.array([3.0, 3.0, 7.0, 7.0]), "y": np.array([3.0, 7.0, 3.0, 7.0])}
    return obs, experts


def _sweep(optim_kwargs, **kw):
    from gpsat_tpu_torch.data.prediction_locations import PredictionLocations
    from gpsat_tpu_torch.experts import sweep

    obs, experts = _sweep_inputs()
    pred_loc = PredictionLocations("shift_arrays", coords_col=["x", "y"], x=np.array([-0.5, 0.5]), y=np.array([0.0]))
    out = list(sweep(obs, experts, coords_col=["x", "y"], obs_col="z",
                     local_select=[{"col": ["x", "y"], "comp": "<", "val": 3.0}], pred_loc=pred_loc,
                     init_params={"kernel": "Matern32", "noise_variance": 0.01},
                     constraints={"lengthscales": {"low": 0.1, "high": 20.0}}, optim_kwargs=optim_kwargs,
                     dtype=torch.float64, device="cpu", **kw))
    return {k: np.concatenate([r[k] for r in out]) for k in ("expert_index", "num_iter", "objective", "f_mean")}, out


def test_sweep_carry_iters_takes_the_plain_sweeps_iterations():
    """The sweep's carry lane (f64 with no linesearch named: carry_iters
    runs single-eval) gives each expert the plain sweep's iterations."""
    plain, _ = _sweep({"max_iter": 300, "linesearch": "single_eval"})
    got, buckets = _sweep({"max_iter": 300, "carry_iters": 4})
    assert all("compaction" in r for r in buckets)
    order = np.argsort(got["expert_index"])
    ref = np.argsort(plain["expert_index"])
    np.testing.assert_array_equal(got["num_iter"][order], plain["num_iter"][ref])
    np.testing.assert_allclose(got["objective"][order], plain["objective"][ref], rtol=1e-12)


def test_sweep_two_stage_iters_reaches_the_plain_sweeps_optima():
    plain, _ = _sweep({"max_iter": 300, "linesearch": "single_eval"})
    got, _ = _sweep({"max_iter": 300, "linesearch": "single_eval", "two_stage_iters": 4})
    order = np.argsort(got["expert_index"])
    ref = np.argsort(plain["expert_index"])
    np.testing.assert_allclose(got["objective"][order], plain["objective"][ref], rtol=1e-8)
    np.testing.assert_allclose(got["f_mean"][order], plain["f_mean"][ref], atol=1e-5)


def test_sgpr_carry_equals_the_single_run_exactly():
    """The SGPR core's head + resumed tail = one run: its inducing points
    (held fixed, drawn per tile) ride through the gather like any param."""
    from gpsat_tpu_torch.models.sgpr import make_sgpr_core

    core = make_sgpr_core(num_inducing_points=16)
    kw = dict(fixed_params=core.default_fixed_params)
    full = TE.make_batched_runner(core, max_iter=400, linesearch="single_eval", device="cpu", **TOLS, **kw)
    gold = TE.run_tile_batch(_batch(), INIT, full, core, device="cpu")
    assert gold["converged"].all() and (gold["num_iter"] > HEAD_ITERS).all()
    head, tail = _runners(core, **kw)
    got = TE.run_tile_batch_carry(_batch(), INIT, head, tail, core, device="cpu")
    _assert_exact(got, gold)
    np.testing.assert_array_equal(got["inducing_points"], gold["inducing_points"])
