"""The port's whole slice (gpsat_tpu_torch/parallel/engine.py down to the
factor pair) against the JAX engine, on one small f64 workload, plus the
port's device rule and import isolation."""

import ast
import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gpsat_tpu.models.functional import make_gpr_core as jax_make_gpr_core
from gpsat_tpu.ops import linalg as JLA
from gpsat_tpu.parallel import batching as JB
from gpsat_tpu.parallel import engine as JE
from gpsat_tpu_torch.convert import batch_from_numpy, params_from_numpy
from gpsat_tpu_torch.models.functional import make_gpr_core
from gpsat_tpu_torch.parallel import batching as TB
from gpsat_tpu_torch.parallel import engine as TE

REPO = Path(__file__).resolve().parent.parent
B, N, P, D = 4, 128, 8, 2
TOLS = dict(tol_grad=1e-6, tol_f=1e-11)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six pytest workers on the
    machine's cores, and torch's default of one thread per core then
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_batch():
    rng = np.random.default_rng(0)
    X = rng.uniform(-6, 6, (B, N, D))
    y = np.sin(X[..., 0]) * np.cos(X[..., 1]) + 0.1 * rng.normal(size=(B, N))
    mask = np.ones((B, N))
    fill = rng.integers(int(0.6 * N), N + 1, size=B)
    for i, f in enumerate(fill):
        mask[i, f:] = 0.0
    Xnew = rng.uniform(-4, 4, (B, P, D))
    return JB.TileBatch(
        X=X, y=y, mask=mask, Xnew=Xnew, pred_mask=np.ones((B, P)),
        obs_mean=np.zeros(B), expert_index=np.arange(B), num_obs=fill,
    )


@pytest.fixture(scope="module")
def runs():
    """One JAX runner compile and run, and the port on the same batch."""
    batch = _jax_batch()
    JLA.set_fast_inverse(True)
    try:
        core = jax_make_gpr_core()
        runner = JE.make_batched_runner(core, linesearch="single_eval", **TOLS)
        ref = JE.run_tile_batch(batch, {"smart_init": True}, runner, core)
    finally:
        JLA.set_fast_inverse(None)
    tcore = make_gpr_core()
    trunner = TE.make_batched_runner(tcore, linesearch="single_eval", device="cpu", **TOLS)
    got = TE.run_tile_batch(batch_from_numpy(batch), {"smart_init": True}, trunner, tcore, device="cpu")
    return batch, ref, got


def test_slice_f64_matches_jax_engine(runs):
    _, ref, got = runs
    np.testing.assert_array_equal(got["converged"], ref["converged"])
    np.testing.assert_array_equal(got["expert_index"], ref["expert_index"])
    assert not got["failed"].any()
    # both stop on |df| <= 1e-11 |f| near a flat optimum: a last-bit
    # difference in f (other factorisation, other sum order) can fire that
    # test an iteration or two apart, so one lane of four may differ in
    # num_iter; that lane is held to the flat optimum's own band below
    same = got["num_iter"] == ref["num_iter"]
    assert same.sum() >= B - 1, (got["num_iter"], ref["num_iter"])
    # relative to max(|ref|, 1e-6), i.e. a 1e-12 absolute floor under the
    # 1e-6 bound: a lane whose noise variance converges to ~1e-11 (noise-free
    # optimum) differs there by roundoff alone (~1e-17 absolute)
    for k in ("lengthscales", "kernel_variance", "likelihood_variance"):
        rel = np.abs(got[k] - ref[k]) / np.maximum(np.abs(ref[k]), 1e-6)
        rel = rel.reshape(B, -1).max(1)
        assert rel[same].max() <= 1e-6, (k, rel)
        assert rel.max() <= 1e-5, (k, rel)
    for k in ("f_mean", "f_var", "y_var"):
        err = np.abs(got[k] - ref[k]).max(1)
        assert err[same].max() <= 1e-8, (k, err)
        assert err.max() <= 1e-6, (k, err)
    np.testing.assert_allclose(got["objective"], ref["objective"], rtol=1e-10)


def test_params_carried_across_predict_like_jax(runs):
    # the JAX result's hyperparameters, converted, give JAX's predictions
    batch, ref, _ = runs
    tcore = make_gpr_core()
    cp = params_from_numpy({k: ref[k] for k in tcore.param_names}, "cpu", torch.float64)
    data = {k: torch.from_numpy(getattr(batch, k)) for k in ("X", "y", "mask")}
    with torch.no_grad():
        pred = tcore.predict(cp, data, torch.from_numpy(batch.Xnew))
    for k in ("f_mean", "f_var", "y_var"):
        np.testing.assert_allclose(pred[k].numpy(), ref[k], rtol=0, atol=1e-10, err_msg=k)
    # the same through the runner with optimise=False
    runner = TE.make_batched_runner(tcore, optimise=False, linesearch="single_eval", device="cpu")
    init = {k: ref[k] for k in tcore.param_names}
    res = TE.run_tile_batch(batch_from_numpy(batch), init, runner, tcore, device="cpu")
    for k in ("f_mean", "f_var", "y_var"):
        np.testing.assert_allclose(res[k], ref[k], rtol=0, atol=1e-10, err_msg=k)
    assert (res["num_iter"] == 0).all() and res["converged"].all()


def test_nan_lane_stays_in_its_lane(runs):
    # one tile with a NaN observation fails alone; the other lanes follow
    # exactly the trajectories of the clean run
    batch, _, clean = runs
    bad = batch_from_numpy(batch)
    bad.y[1, 3] = np.nan
    tcore = make_gpr_core()
    runner = TE.make_batched_runner(tcore, linesearch="single_eval", device="cpu", **TOLS)
    res = TE.run_tile_batch(bad, {"smart_init": True}, runner, tcore, device="cpu")
    assert res["failed"][1] and not res["converged"][1]
    ok = np.arange(B) != 1
    np.testing.assert_array_equal(res["num_iter"][ok], clean["num_iter"][ok])
    np.testing.assert_array_equal(res["f_mean"][ok], clean["f_mean"][ok])


def test_runner_takes_max_linesearch_steps_and_single_eval_ignores_it(runs):
    # the orchestrator passes max_linesearch_steps; the single-eval search
    # takes one step per iteration, so any value gives the same bits
    batch = batch_from_numpy(runs[0])
    tcore = make_gpr_core()
    out = []
    for steps in (1, 32, 1000):
        runner = TE.make_batched_runner(tcore, linesearch="single_eval", max_linesearch_steps=steps, max_iter=10,
                                        device="cpu", **TOLS)
        out.append(TE.run_tile_batch(batch, {"smart_init": True}, runner, tcore, device="cpu"))
    for res in out[1:]:
        for k in ("num_iter", "f_mean", "f_var", "objective", "lengthscales", "kernel_variance"):
            np.testing.assert_array_equal(res[k], out[0][k], err_msg=k)


def test_prepare_batch_init_runs_before_padding_and_only_when_set(runs):
    # three tiles pad to four lanes; the hook sees the three and its values
    # reach the (predict-only) runner, and a core without one keeps the init
    import dataclasses

    batch = batch_from_numpy(runs[0])
    sub = TB.take_batch(batch, np.arange(3))
    seen = []

    def hook(b, init):
        seen.append(b.B)
        return {**init, "kernel_variance": np.array([0.5, 1.5, 2.5])}

    plain = make_gpr_core()
    runner = TE.make_batched_runner(plain, optimise=False, linesearch="single_eval", device="cpu")
    init = {"kernel_variance": np.ones(3), "smart_init": True}
    hooked = TE.run_tile_batch(sub, init, runner, dataclasses.replace(plain, prepare_batch_init=hook), device="cpu")
    assert seen == [3]
    np.testing.assert_allclose(hooked["kernel_variance"], [0.5, 1.5, 2.5], rtol=1e-12)
    res = TE.run_tile_batch(sub, init, runner, plain, device="cpu")
    np.testing.assert_allclose(res["kernel_variance"], np.ones(3), rtol=1e-12)
    np.testing.assert_array_equal(res["lengthscales"], hooked["lengthscales"])


@functools.lru_cache(maxsize=None)
def _odd_width_runs(n):
    """One tile bucket of width n (not a multiple of 64) through the JAX
    engine in f64: GPR with a Constant mean and the RationalQuadratic
    kernel, the single-eval search. One JAX compile per width."""
    rng = np.random.default_rng(n)
    Bn, Pn = 3, 6
    X = rng.uniform(-3, 3, (Bn, n, D))
    y = np.sin(X[..., 0]) * np.cos(X[..., 1]) + 0.5 + 0.1 * rng.normal(size=(Bn, n))
    mask = np.ones((Bn, n))
    mask[1, n - n // 4 :] = 0.0
    batch = JB.TileBatch(X=X, y=y, mask=mask, Xnew=rng.uniform(-2, 2, (Bn, Pn, D)), pred_mask=np.ones((Bn, Pn)),
                         obs_mean=np.zeros(Bn), expert_index=np.arange(Bn), num_obs=mask.sum(1).astype(int))
    kw = dict(kernel="RationalQuadratic", mean_function="Constant", jitter=1e-6)
    core = jax_make_gpr_core(**kw)
    ref = JE.run_tile_batch(batch, {"smart_init": True}, JE.make_batched_runner(core, linesearch="single_eval", **TOLS),
                            core)
    return batch, kw, ref


@pytest.mark.parametrize("n", [96, 40])
@pytest.mark.parametrize("factor", ["block", "panel"])
def test_gpr_tile_widths_off_the_block_match_jax(n, factor):
    """Tile widths that are no multiple of the route's block (96, and 40 <
    64) run on the "block" and "panel" routes, identity-padded to the block,
    and meet the JAX engine's f64 fit (which factors them with plain
    cholesky) within 1e-9 on the predictions."""
    batch, kw, ref = _odd_width_runs(n)
    core = make_gpr_core(factor=factor, **kw)
    runner = TE.make_batched_runner(core, linesearch="single_eval", device="cpu", **TOLS)
    got = TE.run_tile_batch(batch_from_numpy(batch), {"smart_init": True}, runner, core, device="cpu")
    assert got["converged"].all() and np.asarray(ref["converged"]).all()
    for k in ("f_mean", "f_var"):
        d = float(np.abs(got[k] - np.asarray(ref[k])).max())
        assert d <= 1e-9, (n, factor, k, d)


@pytest.mark.parametrize("n", [96, 40, 200])
def test_factor_routes_take_any_width(n):
    """The block and panel routes' factor pairs, and the fused LML on each,
    at widths off their blocks: the identity pad is sliced away exactly."""
    from gpsat_tpu_torch.ops import fused_lml as FL
    from gpsat_tpu_torch.ops import linalg as TLA

    rng = np.random.default_rng(n)
    A = torch.tensor(rng.normal(size=(2, n, n)))
    K = A @ A.transpose(1, 2) / n + torch.eye(n)
    L_ref = torch.linalg.cholesky(K)
    L, W = TLA.chol_winv_batched(K)
    Lp, Wdiag = TLA.chol_panels_batched(K)
    assert Wdiag.shape[1] == -(-n // 128)
    eye = torch.eye(n, dtype=K.dtype)
    for got in (L, Lp):
        torch.testing.assert_close(got, L_ref, rtol=0, atol=1e-12)
    torch.testing.assert_close(W @ L_ref, eye.expand_as(K), rtol=0, atol=1e-10)
    torch.testing.assert_close(TLA.tri_inv_from_diag(Lp, Wdiag) @ L_ref, eye.expand_as(K), rtol=0, atol=1e-10)
    b = torch.tensor(rng.normal(size=(2, n, 3)))
    want = torch.linalg.solve_triangular(L_ref, b, upper=False)
    torch.testing.assert_close(TLA.tri_solve_from_diag(Lp, Wdiag, b), want, rtol=0, atol=1e-10)
    X = torch.tensor(rng.uniform(-3, 3, (2, n, D)))
    y = torch.tensor(rng.normal(size=(2, n)))
    mask = torch.ones(2, n, dtype=X.dtype)
    mask[1, n // 2 :] = 0.0
    args = [torch.tensor([[1.1, 0.7], [0.9, 1.3]]), torch.tensor([1.2, 0.8]), torch.tensor([0.1, 0.2])]
    want = TLA.masked_gpr_lml(X, y, mask, *args, kernel="Matern32")
    for factor in ("block", "panel"):
        got = FL.masked_gpr_lml_fused("Matern32", X, y, mask, *args, 0.0, factor)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule cannot be observed")
    core = make_gpr_core()
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.make_batched_runner(core)
    runner = TE.make_batched_runner(core, device="cpu")
    batch = batch_from_numpy(_jax_batch())
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.run_tile_batch(batch, {}, runner, core)
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.run_tile_batch_async(batch, {}, runner, core)


def test_unported_options_raise():
    core = make_gpr_core()
    # the mesh is ported: an unreadable mesh spec is refused
    with pytest.raises(TypeError, match="mesh must be"):
        TE.make_batched_runner(core, mesh=object(), device="cpu")
    # the profiled core is ported, but only over plain positive variances
    from gpsat_tpu_torch.ops import transforms as TT

    with pytest.raises(AssertionError):
        make_gpr_core(profile_variance=True, bijectors={"kernel_variance": TT.interval(0.1, 5.0)})
    with pytest.raises(ValueError):
        make_gpr_core(factor="lapack")
    # the f64 default line search is zoom, and it runs
    assert TE.resolve_linesearch(None, torch.float64) == "zoom"
    assert TE.resolve_linesearch(None, torch.float32) == "single_eval"
    with pytest.raises(ValueError, match="not in"):
        TE.resolve_linesearch("wolfe", torch.float64)
    runner = TE.make_batched_runner(core, device="cpu", max_iter=1)
    res = TE.run_tile_batch(batch_from_numpy(_jax_batch()), {}, runner, core, device="cpu")
    assert (res["num_iter"] == 1).all() and np.isfinite(res["f_mean"]).all()


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_gpsat_tpu():
    code = (
        "import sys, gpsat_tpu_torch.parallel.engine, gpsat_tpu_torch.convert, gpsat_tpu_torch.utils.flops\n"
        "import gpsat_tpu_torch.ops._build, gpsat_tpu_torch.ops.panel_chol, gpsat_tpu_torch.ops.cholesky\n"
        "import gpsat_tpu_torch.ops.recursive_chol, gpsat_tpu_torch.ops.linalg, gpsat_tpu_torch.ops.fused_lml\n"
        "import gpsat_tpu_torch.experts, gpsat_tpu_torch.local_expert_oi, gpsat_tpu_torch.models\n"
        "import gpsat_tpu_torch.models.sgpr, gpsat_tpu_torch.models.svgp\n"
        "import gpsat_tpu_torch.models.vff, gpsat_tpu_torch.models.asvgp, gpsat_tpu_torch.models.base\n"
        "import gpsat_tpu_torch.models.pure_numpy_gpr, gpsat_tpu_torch.models.sklearn_model\n"
        "import gpsat_tpu_torch.models.torch_gpr, gpsat_tpu_torch.models.base_model, gpsat_tpu_torch.decorators\n"
        "import gpsat_tpu_torch.models.gpflow_models, gpsat_tpu_torch.models.sklearn_models\n"
        "import gpsat_tpu_torch.models.pure_python_gpr, gpsat_tpu_torch.models.gpytorch_models\n"
        "import gpsat_tpu_torch.models.vff_model, gpsat_tpu_torch.models.asvgp_model, gpsat_tpu_torch.local_experts\n"
        "assert 'sklearn' not in sys.modules, 'sklearn is imported when a model is built'\n"
        "import gpsat_tpu_torch.data.dataloader, gpsat_tpu_torch.data.store, gpsat_tpu_torch.data.select\n"
        "import gpsat_tpu_torch.data.prediction_locations, gpsat_tpu_torch.utils.misc, gpsat_tpu_torch.utils.config_func\n"
        "import gpsat_tpu_torch.postprocess, gpsat_tpu_torch.postprocessing, gpsat_tpu_torch.cli\n"
        "import gpsat_tpu_torch.models.multioutput, gpsat_tpu_torch.models.multioutput.gpr\n"
        "import gpsat_tpu_torch.models.multioutput.likelihoods, gpsat_tpu_torch.models.multioutput.utils\n"
        "import gpsat_tpu_torch.data.pytables_compat, gpsat_tpu_torch.data.ingest, gpsat_tpu_torch.data.binning\n"
        "import gpsat_tpu_torch.read_and_store, gpsat_tpu_torch.bin_data, gpsat_tpu_torch.datetime_utils\n"
        "import gpsat_tpu_torch.utils.projections, gpsat_tpu_torch.distributed\n"
        "import gpsat_tpu_torch.native, gpsat_tpu_torch.build_native, gpsat_tpu_torch.data.blosc\n"
        "import gpsat_tpu_torch.data.zarr_reader, gpsat_tpu_torch.data.netcdf, gpsat_tpu_torch.data.expert_locations\n"
        "import gpsat_tpu_torch.utils, gpsat_tpu_torch.utils.grids, gpsat_tpu_torch.utils.tables\n"
        "import gpsat_tpu_torch.utils.weights, gpsat_tpu_torch.synthetic, gpsat_tpu_torch.config\n"
        "import gpsat_tpu_torch.config_dataclasses, gpsat_tpu_torch.xval, gpsat_tpu_torch.prime_cache\n"
        "import gpsat_tpu_torch.dataloader, gpsat_tpu_torch.dataprepper, gpsat_tpu_torch.vff\n"
        "import gpsat_tpu_torch.prediction_locations\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'gpsat_tpu' or m.startswith('gpsat_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

    scripts = ("chip_smoke.py", "bench_block_chol.py", "bench_panel_chol.py", "bench_cholesky.py")
    sources = sorted((REPO / "gpsat_tpu_torch").rglob("*.py")) + [REPO / name for name in scripts]
    for path in sources:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "gpsat_tpu", "optax"), f"{path.relative_to(REPO)} imports {mod}"
        assert "GPSAT_" not in path.read_text(), f"{path.relative_to(REPO)} names a GPSAT_* environment variable"
    # the C++ host library's source: no include or mention of the JAX package
    for path in sorted((REPO / "gpsat_tpu_torch" / "csrc" / "host").glob("*")):
        text = path.read_text()
        assert not re.search(r"\bjax\b|\bxla\b|gpsat_tpu(?!_torch)\b", text, re.IGNORECASE), path.name
