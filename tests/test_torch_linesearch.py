"""The port's probing L-BFGS searches (gpsat_tpu_torch/optim/lbfgs.py: zoom,
the f64 default, and backtracking) against the JAX package's
``minimize_lbfgs`` (optax 0.2.6 underneath) on the CPU in f64, on a batch
of Rosenbrock lanes run in lockstep.

Bounds: iterates after 1 and 3 iterations within 1e-10; after a run to
convergence, final values within 1e-10 and iteration counts within 1. One
lane is an exception to the last bound under zoom: from the classic start
(-1.2, 1) the two programs' f64 roundoff (1e-14 after 20 iterations)
grows about 100x every 10 iterations along the valley, so the two runs
converge to the same point in different numbers of iterations; for that
lane the test holds the iterates within 1e-12 after 15 iterations instead.
Two small JAX programs are compiled (one per search, the iteration budget
a traced argument)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsat_tpu.optim import lbfgs as JL
from gpsat_tpu_torch.optim import lbfgs as TL

ITER_TOL = 1e-10
VALUE_TOL = 1e-10
# the classic Rosenbrock start first; (1, 1) starts at the optimum
X0 = np.array([[-1.2, 1.0], [0.5, -0.3], [2.0, 2.0], [1.0, 1.0], [-0.5, 0.5], [1.5, 2.5]])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rosen_jax(p):
    x = p["x"]
    return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2


def _rosen_torch(p):
    x = p["x"]
    return (1 - x[:, 0]) ** 2 + 100 * (x[:, 1] - x[:, 0] ** 2) ** 2


@functools.lru_cache(maxsize=None)
def _jax_program(linesearch):
    return jax.jit(jax.vmap(lambda p, it: JL.minimize_lbfgs(_rosen_jax, p, max_iter=it, linesearch=linesearch),
                            in_axes=(0, None)))


def _both(linesearch, max_iter, x0=X0):
    jr = _jax_program(linesearch)({"x": jnp.asarray(x0)}, max_iter)
    tr = TL.minimize_lbfgs(_rosen_torch, {"x": torch.tensor(x0)}, max_iter=max_iter, linesearch=linesearch)
    return jr, tr


@pytest.mark.parametrize("linesearch", ["zoom", "backtracking"])
@pytest.mark.parametrize("iters", [1, 3])
def test_iterates_match_jax(linesearch, iters):
    jr, tr = _both(linesearch, iters)
    np.testing.assert_allclose(tr.params["x"].numpy(), np.asarray(jr.params["x"]), rtol=0, atol=ITER_TOL)
    np.testing.assert_allclose(tr.final_value.numpy(), np.asarray(jr.final_value), rtol=0, atol=ITER_TOL)
    np.testing.assert_array_equal(tr.num_iter.numpy(), np.asarray(jr.num_iter))
    for k in ("converged", "failed", "stalled"):
        np.testing.assert_array_equal(getattr(tr, k).numpy(), np.asarray(getattr(jr, k)), err_msg=k)


@pytest.mark.parametrize("linesearch", ["zoom", "backtracking"])
def test_run_to_convergence_matches_jax(linesearch):
    jr, tr = _both(linesearch, 500)
    np.testing.assert_allclose(tr.final_value.numpy(), np.asarray(jr.final_value), rtol=0, atol=VALUE_TOL)
    for k in ("converged", "failed", "stalled"):
        np.testing.assert_array_equal(getattr(tr, k).numpy(), np.asarray(getattr(jr, k)), err_msg=k)
    # the lane that starts at the optimum is done after its first iteration
    assert int(tr.num_iter[3]) == 1 and bool(tr.converged[3])
    d_iter = np.abs(tr.num_iter.numpy() - np.asarray(jr.num_iter))
    if linesearch == "zoom":
        # the classic start: see the module docstring
        assert (d_iter[1:] <= 1).all(), d_iter
        j15, t15 = _both(linesearch, 15, X0[:1])
        np.testing.assert_allclose(t15.params["x"].numpy(), np.asarray(j15.params["x"]), rtol=0, atol=1e-12)
    else:
        assert (d_iter <= 1).all(), d_iter


def test_a_failed_lane_leaves_the_others_alone():
    """A lane whose start is not finite fails at once and keeps its iterate;
    the other lanes take exactly the iterations of a run without it."""
    x0 = np.concatenate([X0[1:3], [[np.nan, 0.0]]])
    for linesearch in ("zoom", "backtracking"):
        alone = TL.minimize_lbfgs(_rosen_torch, {"x": torch.tensor(X0[1:3])}, max_iter=60, linesearch=linesearch)
        got = TL.minimize_lbfgs(_rosen_torch, {"x": torch.tensor(x0)}, max_iter=60, linesearch=linesearch)
        assert bool(got.failed[2]) and int(got.num_iter[2]) == 0 and not bool(got.converged[2])
        torch.testing.assert_close(got.params["x"][:2], alone.params["x"], rtol=0, atol=0)
        torch.testing.assert_close(got.num_iter[:2], alone.num_iter, rtol=0, atol=0)


def test_zoom_is_the_f64_default_and_the_search_budget_binds():
    """minimize_lbfgs defaults to zoom; with max_linesearch_steps 1 the
    search ends at its first trial, and JAX agrees iterate for iterate."""
    x0 = {"x": torch.tensor(X0[:3])}
    default = TL.minimize_lbfgs(_rosen_torch, x0, max_iter=3)
    zoom = TL.minimize_lbfgs(_rosen_torch, x0, max_iter=3, linesearch="zoom")
    torch.testing.assert_close(default.params["x"], zoom.params["x"], rtol=0, atol=0)
    short = TL.minimize_lbfgs(_rosen_torch, x0, max_iter=3, linesearch="zoom", max_linesearch_steps=1)
    jr = jax.vmap(lambda p: JL.minimize_lbfgs(_rosen_jax, p, max_iter=3, linesearch="zoom",
                                              max_linesearch_steps=1))({"x": jnp.asarray(X0[:3])})
    np.testing.assert_allclose(short.params["x"].numpy(), np.asarray(jr.params["x"]), rtol=0, atol=ITER_TOL)
    assert not torch.equal(short.params["x"], zoom.params["x"])
