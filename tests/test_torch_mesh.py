"""The port's expert mesh (gpsat_tpu_torch/parallel/engine.py and the
orchestrator's ``mesh=``) on the CPU, where one device stands in for
several: the padding rule against the JAX engine's, meshed runs against
unmeshed ones and against the JAX engine's ``shard_map`` over the
conftest's 8 fake CPU devices, the compaction, polish and Adam runner under
a mesh, ``LocalExpertOI.run(mesh=...)`` and the refusals.

One JAX program is compiled: the GPR runner shard_mapped over 8 devices."""

import types

import numpy as np
import pandas as pd
import pytest
import torch

from gpsat_tpu.models.functional import make_gpr_core as jax_make_gpr_core
from gpsat_tpu.ops import linalg as JLA
from gpsat_tpu.parallel import batching as JB
from gpsat_tpu.parallel import engine as JE
from gpsat_tpu_torch.convert import batch_from_numpy
from gpsat_tpu_torch.experts import LocalExpertOI as TOI
from gpsat_tpu_torch.experts import get_results_from_h5file
from gpsat_tpu_torch.models.functional import make_gpr_core
from gpsat_tpu_torch.parallel import engine as TE

TOLS = dict(linesearch="single_eval", tol_grad=1e-6, tol_f=1e-11)
MESH3 = ("cpu",) * 3
RESULT_KEYS = ("f_mean", "f_var", "y_var", "objective", "lengthscales", "kernel_variance", "likelihood_variance")
EXIT_KEYS = ("expert_index", "num_iter", "converged", "stalled", "failed")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six pytest workers on the
    machine's cores, and torch's default of one thread per core then
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(B=9, N=48, P=4, D=2, seed=3):
    """An uneven bucket of B tiles, 60-100 % full."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-6, 6, (B, N, D))
    y = np.sin(X[..., 0]) * np.cos(X[..., 1]) + 0.1 * rng.normal(size=(B, N))
    mask = np.ones((B, N))
    fill = rng.integers(int(0.6 * N), N + 1, size=B)
    for i, f in enumerate(fill):
        mask[i, f:] = 0.0
    return JB.TileBatch(X=X, y=y, mask=mask, Xnew=rng.uniform(-4, 4, (B, P, D)), pred_mask=np.ones((B, P)),
                        obs_mean=np.zeros(B), expert_index=np.arange(B), num_obs=fill)


def assert_same_results(got, want, tol, keys=RESULT_KEYS):
    for k in EXIT_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


def _jax_padded_width(B, pad_multiple, n_dev):
    """The JAX engine's padding of a bucket of B under a mesh of n_dev
    devices, as ``gpsat_tpu/parallel/engine.py:441-451`` (and the carry's
    tail, ``:570-577``) write it."""
    if pad_multiple:
        step = int(np.lcm(int(pad_multiple), max(n_dev, 1)))
        return int(-(-B // step) * step)
    B_pad = max(n_dev, 1)
    while B_pad < B:
        B_pad *= 2
    return int(-(-B_pad // n_dev) * n_dev)


PAD_TABLE = [(1, None, 1), (5, None, 1), (5, None, 2), (9, None, 3), (9, None, 8), (3, None, 6), (1664, 128, 1),
             (1664, 128, 2), (1664, 128, 3), (100, 128, 8), (17, 6, 4), (12, 6, 4), (833, None, 3), (0, None, 2)]


@pytest.mark.parametrize("B, pad_multiple, n_dev", PAD_TABLE)
def test_padded_width_matches_jax(B, pad_multiple, n_dev):
    assert TE.padded_width(B, pad_multiple, n_dev) == _jax_padded_width(B, pad_multiple, n_dev)


def test_jax_engine_pads_as_transcribed():
    """The transcription above against the JAX engine itself: the width its
    runner receives for a bucket of 9 under a (fake) mesh of 3."""
    B, widths = 9, []
    tiny = JB.TileBatch(X=np.zeros((B, 1, 1)), y=np.zeros((B, 1)), mask=np.ones((B, 1)), Xnew=np.zeros((B, 1, 1)),
                        pred_mask=np.ones((B, 1)), obs_mean=np.zeros(B), expert_index=np.arange(B),
                        num_obs=np.ones(B, dtype=int))
    fake_mesh = types.SimpleNamespace(devices=np.empty(3, dtype=object))
    JE.run_tile_batch_async(tiny, {}, lambda X, *rest: widths.append(X.shape[0]), jax_make_gpr_core(),
                            mesh=fake_mesh)
    assert widths == [_jax_padded_width(B, None, 3)] == [12]


@pytest.fixture(scope="module")
def runs():
    """The uneven bucket of 9 in f64: JAX over its 8-device mesh (shards of
    2 of 16), the port unmeshed (16 wide) and over 3 CPU shards (4 of 12)."""
    batch = _batch()
    JLA.set_fast_inverse(True)
    try:
        core, mesh = jax_make_gpr_core(), JE.default_mesh()
        assert mesh.devices.size == 8
        ref = JE.run_tile_batch(batch, {"smart_init": True}, JE.make_batched_runner(core, mesh=mesh, **TOLS), core,
                                mesh=mesh)
    finally:
        JLA.set_fast_inverse(None)
    tcore, tbatch = make_gpr_core(), batch_from_numpy(batch)
    plain = TE.run_tile_batch(tbatch, {"smart_init": True}, TE.make_batched_runner(tcore, device="cpu", **TOLS),
                              tcore, device="cpu")
    meshed = TE.run_tile_batch(tbatch, {"smart_init": True},
                               TE.make_batched_runner(tcore, mesh=MESH3, device="cpu", **TOLS), tcore, mesh=MESH3,
                               device="cpu")
    return ref, plain, meshed


def test_meshed_run_matches_unmeshed(runs):
    _, plain, meshed = runs
    assert len(meshed["expert_index"]) == 9 and meshed["converged"].all()
    assert_same_results(meshed, plain, 1e-12)


def test_meshed_run_matches_jax_mesh(runs):
    ref, _, meshed = runs
    np.testing.assert_array_equal(meshed["expert_index"], ref["expert_index"])
    np.testing.assert_array_equal(meshed["converged"], ref["converged"])
    for k in ("f_mean", "f_var", "y_var"):
        np.testing.assert_allclose(meshed[k], ref[k], rtol=0, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(meshed["objective"], ref["objective"], rtol=1e-10)


@pytest.mark.parametrize("part", ["carry", "two_stage", "polish", "adam"])
def test_compaction_polish_and_adam_under_mesh(part):
    """Each part on a mesh of 2 against the same part with no mesh."""
    batch, core = batch_from_numpy(_batch(B=5, N=16, seed=5)), make_gpr_core()

    def run(mesh):
        kw = dict(mesh=mesh, device="cpu")
        if part == "carry":
            head = TE.make_batched_runner(core, max_iter=8, return_state=True, **TOLS, **kw)
            tail = TE.make_batched_runner(core, max_iter=20, take_state=True, return_state=True, **TOLS, **kw)
            return TE.run_tile_batch_carry(batch, {}, head, tail, core, **kw)
        if part == "two_stage":
            head = TE.make_batched_runner(core, max_iter=8, **TOLS, **kw)
            tail = TE.make_batched_runner(core, max_iter=20, **TOLS, **kw)
            return TE.run_tile_batch_two_stage(batch, {}, head, tail, core, **kw)
        if part == "polish":
            coarse = TE.run_tile_batch(batch, {}, TE.make_batched_runner(core, max_iter=5, **TOLS, device="cpu"),
                                       core, device="cpu")
            return TE.polish_tile_batch(batch, coarse, core, max_iter=20, **kw)
        runner = TE.make_batched_adam_runner(core, max_iter=30, check_every=5, persistence=10, **kw)
        return TE.run_tile_batch(batch, {}, runner, core, **kw)

    plain, meshed = run(None), run(2)
    assert_same_results(meshed, plain, 1e-12)
    if part in ("carry", "two_stage"):
        c, p = meshed["compaction"], plain["compaction"]
        assert c["tail_width"] > 0 and c["tail_width"] % 2 == 0 and c["head_width"] == p["head_width"] == 8
        np.testing.assert_array_equal(c["tail_num_iter"], p["tail_num_iter"])


def _field():
    """The synthetic field and 2x2 expert grid of tests/test_torch_oi.py."""
    rng = np.random.default_rng(11)
    n = 500
    x, y = rng.uniform(0, 10, n), rng.uniform(0, 10, n)
    obs = pd.DataFrame({"x": x, "y": y, "obs": np.sin(x) * np.cos(y) + 0.1 * rng.normal(size=n)})
    experts = pd.DataFrame({"x": [3.0, 3.0, 7.0, 7.0], "y": [3.0, 7.0, 3.0, 7.0]})
    return dict(
        expert_loc_config={"source": experts},
        data_config={"data_source": obs, "obs_col": "obs", "coords_col": ["x", "y"],
                     "local_select": [{"col": ["x", "y"], "comp": "<", "val": 3.0}]},
        model_config={"oi_model": "GPflowGPRModel", "init_params": {"kernel": "Matern32", "noise_variance": 0.01},
                      "optim_kwargs": {"max_iter": 20, "polish": "f64", "polish_max_iter": 5}},
        pred_loc_config={"method": "shift_arrays", "x": np.array([-0.5, 0.0, 0.5]), "y": np.array([0.0])},
    )


@pytest.fixture(scope="module")
def oi_plain(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh_oi") / "plain.h5")
    TOI(**_field()).run(store_path=path, device="cpu")
    return get_results_from_h5file(path)[0]


@pytest.mark.parametrize("mesh", [2, "all"])
def test_local_expert_oi_run_with_mesh(mesh, oi_plain, tmp_path):
    """Tables equal to the unmeshed run's (f32 fit, f64 polish), and the
    device column names the mesh's first device."""
    path = str(tmp_path / "meshed.h5")
    TOI(**_field()).run(store_path=path, device="cpu", mesh=mesh)
    got = get_results_from_h5file(path)[0]
    assert set(got) == set(oi_plain)
    for t, want in oi_plain.items():
        have = got[t]
        assert list(have.columns) == list(want.columns), t
        for c in have.columns:
            if c in ("run_time", "datetime"):
                continue
            if have[c].dtype.kind == "f":
                np.testing.assert_allclose(have[c].to_numpy(), want[c].to_numpy(), rtol=0, atol=1e-12,
                                           err_msg=f"{t}.{c}")
            else:
                assert have[c].tolist() == want[c].tolist(), f"{t}.{c}"
    assert set(got["run_details"]["device"]) == {"cpu"}


def test_mesh_refusals():
    core, batch = make_gpr_core(), batch_from_numpy(_batch(B=4, N=16, seed=1))
    # the JSON forms, and what they refuse
    # no mesh: the device alone, one shard
    assert TE.resolve_mesh(None, "cpu") == (torch.device("cpu"),)
    assert TE.resolve_mesh(3, "cpu") == (torch.device("cpu"),) * 3
    assert TE.resolve_mesh("all", "cpu") == TE.resolve_mesh(True, "cpu") == (torch.device("cpu"),)
    assert TE.resolve_mesh(["cpu", torch.device("cpu")]) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="mixes"):
        TE.resolve_mesh(["cpu", "cuda:0"])
    for bad, err in (("bogus", ValueError), (0, ValueError), (False, ValueError), ([], ValueError),
                     (object(), TypeError)):
        with pytest.raises(err):
            TE.resolve_mesh(bad, "cpu")
    if not torch.cuda.is_available():
        # a mesh that names a card that is not there
        for missing in (["cuda:0"], 1, "all"):
            with pytest.raises(RuntimeError, match="CUDA|cards"):
                TE.resolve_mesh(missing)
    # a meshed runner refuses an unmeshed batch, and the reverse
    with pytest.raises(ValueError, match="built for"):
        TE.run_tile_batch(batch, {}, TE.make_batched_runner(core, device="cpu"), core, mesh=2, device="cpu")
    with pytest.raises(ValueError, match="built for"):
        TE.run_tile_batch(batch, {}, TE.make_batched_runner(core, mesh=2, device="cpu"), core, device="cpu")
    with pytest.raises(ValueError, match="built for"):
        TE.run_tile_batch(batch, {}, TE.make_batched_runner(core, mesh=2, device="cpu"), core, mesh=3, device="cpu")

    # a failed shard raises in the caller, with its shard named
    def fn(d, x):
        if x[0] >= 2:
            raise FloatingPointError("shard 1 fails")
        return {"x": x * 2}

    with pytest.raises(FloatingPointError) as info:
        TE.run_on_mesh(("cpu",) * 2, fn, (torch.arange(4),))
    assert "mesh shard 1 of 2" in "".join(getattr(info.value, "__notes__", []))
    assert TE.run_on_mesh(("cpu",) * 2, lambda d, x: {"x": x * 2}, (torch.arange(4),))["x"].tolist() == [0, 2, 4, 6]
    with pytest.raises(ValueError, match="equal shards"):
        TE.run_on_mesh(("cpu",) * 3, fn, (torch.arange(4),))


def test_launch_counter_and_library_load_are_thread_safe(monkeypatch, tmp_path):
    """Eight threads, a short switch interval: no increment of a launch
    counter is lost, and a library reached by every thread at once is built
    and loaded once."""
    import sys
    import threading
    import time

    from gpsat_tpu_torch.ops import _build

    def counter():
        pass

    counter.launches = 0
    builds = []

    def slow_build(name):
        builds.append(name)
        time.sleep(0.05)  # every other thread arrives meanwhile
        return tmp_path / f"lib{name}.so"

    monkeypatch.setattr(_build, "_build_library", slow_build)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: types.SimpleNamespace(entry=lambda *a: 0))
    loaded = []

    def work():
        loaded.append(_build.load_library("fake", {"entry": []}))
        for _ in range(2000):
            _build.count_launch(counter)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counter.launches == 8 * 2000
    assert builds == ["fake"] and len(loaded) == 8 and all(lib is loaded[0] for lib in loaded)
