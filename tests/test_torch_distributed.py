"""The port's multi-process sweep (gpsat_tpu_torch/distributed.py) on the
CPU: the partition, store paths and run token against the JAX package's,
run-scoped completion markers, ``merge_stores`` table for table against
``gpsat_tpu.distributed.merge_stores`` on the same per-host files, and two
processes joined over gloo through the CLI, whose merged store equals a
single-process run's. Nothing here compiles a JAX program."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from gpsat_tpu import distributed as JD
from gpsat_tpu_torch import distributed as TD
from gpsat_tpu_torch.data.store import TableStore
from gpsat_tpu_torch.experts import LocalExpertOI as TOI

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six pytest workers on the
    machine's cores, and torch's default of one thread per core then
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_partition_paths_and_token_match_jax():
    locs = pd.DataFrame({"x": np.arange(7.0), "y": np.arange(7.0) * 2}, index=np.arange(10, 17))
    for n in (1, 2, 3):
        for h in range(n):
            pd.testing.assert_frame_equal(TD.partition_expert_locs(locs, n, h), JD.partition_expert_locs(locs, n, h))
    parts = [TD.partition_expert_locs(locs, 3, h) for h in range(3)]
    assert sorted(x for p in parts for x in p["x"]) == list(range(7))
    for path, h in (("a/b/res.h5", 2), ("res", 0), ("r.x.h5", 1)):
        assert TD.host_store_path(path, h) == JD.host_store_path(path, h)
    cfg = {"model": {"oi_model": "GPflowGPRModel", "init_params": {"coords_scale": [1, 2]}},
           "data": {"obs_col": "obs"}, "run_kwargs": {"store_path": "X"}, "misc": "m"}
    for table in (None, locs):
        assert TD.run_token(cfg, table) == JD.run_token(cfg, table)
    other = {**cfg, "model": {"oi_model": "GPflowSGPRModel"}}
    assert TD.run_token(other, locs) != TD.run_token(cfg, locs) != TD.run_token(cfg, locs.iloc[:5])
    # run_kwargs and misc do not enter the token
    assert TD.run_token({**cfg, "run_kwargs": {"store_path": "Y"}}, locs) == TD.run_token(cfg, locs)


def test_init_distributed_without_a_group_and_local_mesh(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert TD.init_distributed() == (0, 1)
    assert TD.init_distributed() == (0, 1)
    with pytest.raises(ValueError, match="process id"):
        TD.init_distributed("localhost:1", 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TD.local_mesh()
        monkeypatch.setenv("LOCAL_RANK", "1")
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
        with pytest.raises(RuntimeError, match="CUDA"):
            TD.local_mesh()


def test_completion_markers_are_run_scoped(tmp_path):
    """A stale marker (another config sharing the store, or a run over fewer
    locations) does not release the wait for this run."""
    locs = pd.DataFrame({"x": [0.0, 1.0], "y": [0.0, 1.0]})
    tok_a = TD.run_token({"model": {"oi_model": "GPflowGPRModel"}}, locs)
    tok_b = TD.run_token({"model": {"oi_model": "GPflowSGPRModel"}}, locs)
    tok_fewer = TD.run_token({"model": {"oi_model": "GPflowGPRModel"}}, locs.iloc[:1])
    p = str(tmp_path / "r.h0.h5")
    assert not TD.host_is_complete(p)
    TD.mark_host_complete(p, 0, token=tok_b)
    assert TD.host_is_complete(p) and TD.host_is_complete(p, token=tok_b)
    assert not TD.host_is_complete(p, token=tok_a) and not TD.host_is_complete(p, token=tok_fewer)
    with pytest.raises(TimeoutError):
        TD.wait_for_hosts([p], timeout=0.2, poll=0.05, token=tok_a)
    # the JAX package reads the port's marker the same way
    assert JD.host_is_complete(p, token=tok_b) and not JD.host_is_complete(p, token=tok_a)
    TD.clear_host_marker(p)
    assert not TD.host_is_complete(p)
    TD.mark_host_complete(p, 0, token=tok_a)
    TD.wait_for_hosts([p], timeout=1.0, poll=0.05, token=tok_a)


def _write_hosts(tmp_path, case):
    """Per-host stores (the port's TableStore; the file format is the JAX
    package's) after tests/test_distributed.py:226-300."""
    cfg_a, cfg_b = {"model": {"oi_model": "GPflowGPRModel"}}, {"model": {"oi_model": "GPflowSGPRModel"}}
    if case == "dedupe":
        # every host stores the same config; only run_kwargs differ
        for h in range(2):
            with TableStore(str(tmp_path / f"r.h{h}.h5")) as store:
                c = {**cfg_a, "run_kwargs": {"store_path": f"r.h{h}.h5"}}
                store.append("oi_config", pd.DataFrame({"config_id": [0], "datetime": ["t"],
                                                        "config": [json.dumps(c)]}))
                store.append("run_details", pd.DataFrame({"num_obs": [h + 1]}, index=pd.Index([float(h)], name="x")))
                store.append("preds", pd.DataFrame(
                    {"x": [1.0 - h, 1.0 - h, 0.5], "pred_loc_x": [0.2, 0.1, 0.3], "f*": [h, h + 0.5, 2.0 * h]}
                ).set_index("x"))
        return
    # host 0 ran A (id 0) then B (id 1); host 1 only B (id 0), and a suffixed pair
    with TableStore(str(tmp_path / "r.h0.h5")) as store:
        store.append("oi_config", pd.DataFrame({"config_id": [0, 1], "datetime": ["t", "t"],
                                                "config": [json.dumps(cfg_a), json.dumps(cfg_b)]}))
        store.append("run_details", pd.DataFrame({"num_obs": [10, 11], "config_id": [0, 1]},
                                                 index=pd.Index([0.0, 1.0], name="x")))
        store.append("oi_config_s", pd.DataFrame({"config_id": [0], "datetime": ["t"], "config": [json.dumps(cfg_b)]}))
        store.append("run_details_s", pd.DataFrame({"num_obs": [5], "config_id": [0]}, index=pd.Index([4.0], name="x")))
    with TableStore(str(tmp_path / "r.h1.h5")) as store:
        store.append("oi_config", pd.DataFrame({"config_id": [0], "datetime": ["t"], "config": [json.dumps(cfg_b)]}))
        store.append("run_details", pd.DataFrame({"num_obs": [12], "config_id": [0]},
                                                 index=pd.Index([2.0], name="x")))
        store.append("oi_config_s", pd.DataFrame({"config_id": [0, 1], "datetime": ["t", "t"],
                                                  "config": [json.dumps(cfg_a), json.dumps(cfg_b)]}))
        store.append("run_details_s", pd.DataFrame({"num_obs": [6, 7], "config_id": [1, 0]},
                                                   index=pd.Index([3.0, 5.0], name="x")))
    TD.mark_host_complete(str(tmp_path / "r.h1.h5"), 1, token="t")


def _tables(path):
    with TableStore(path, mode="r") as store:
        return {t: store.select(t, set_index=False) for t in store.keys()}, \
            {t: json.loads(store._h5[t].attrs["index_cols"]) for t in store.keys()}


@pytest.mark.parametrize("case", ["dedupe", "remap"])
def test_merge_stores_matches_jax(case, tmp_path):
    _write_hosts(tmp_path, case)
    pattern = str(tmp_path / "r.h*.h5")
    got_names = TD.merge_stores(pattern, str(tmp_path / "port.h5"))
    want_names = JD.merge_stores(pattern, str(tmp_path / "jax.h5"))
    assert sorted(got_names) == sorted(want_names)
    got, got_idx = _tables(str(tmp_path / "port.h5"))
    want, want_idx = _tables(str(tmp_path / "jax.h5"))
    assert got_idx == want_idx and set(got) == set(want)
    for t in want:
        pd.testing.assert_frame_equal(got[t], want[t], check_exact=True, obj=t)
    if case == "remap":
        cfgs = got["oi_config"]
        assert list(cfgs["config_id"]) == [0, 1]
        by_model = {json.loads(c)["model"]["oi_model"]: i for c, i in zip(cfgs["config"], cfgs["config_id"])}
        assert list(got["run_details"]["config_id"]) == [by_model["GPflowGPRModel"], by_model["GPflowSGPRModel"],
                                                         by_model["GPflowSGPRModel"]]
    else:
        assert len(got["oi_config"]) == 1 and list(got["preds"]["x"]) == [0.0, 0.0, 0.5, 0.5, 1.0, 1.0]
    with pytest.raises(AssertionError, match="exists"):
        TD.merge_stores(pattern, str(tmp_path / "port.h5"))


def _small_config(tmp_path) -> dict:
    """A GPR experiment config on 400 observations and 6 experts written to
    ``tmp_path``: each tile of 65-128 points, one shape bucket on every
    process of a two-process run."""
    rng = np.random.default_rng(7)
    n = 400
    obs = pd.DataFrame({"x": rng.uniform(0, 10, n), "y": rng.uniform(0, 10, n)})
    obs["obs"] = np.sin(obs["x"]) * np.cos(obs["y"]) + 0.1 * rng.normal(size=n)
    obs.to_csv(tmp_path / "obs.csv", index=False)
    # 6 experts, each tile of 65-128 points: one shape bucket on every process
    pd.DataFrame({"x": [2.0, 2.0, 5.0, 5.0, 8.0, 8.0], "y": [2.5, 7.5, 2.5, 7.5, 2.5, 7.5]}).to_csv(
        tmp_path / "experts.csv", index=False)
    return {
        "locations": {"source": str(tmp_path / "experts.csv")},
        "data": {"data_source": str(tmp_path / "obs.csv"), "obs_col": "obs", "coords_col": ["x", "y"],
                 "local_select": [{"col": ["x", "y"], "comp": "<", "val": 2.5}]},
        "model": {"oi_model": "GPflowGPRModel", "init_params": {"kernel": "Matern32", "noise_variance": 0.01},
                  "optim_kwargs": {"max_iter": 40, "linesearch": "single_eval"}},
        "pred_loc": {"method": "expert_loc"},
    }


def test_run_distributed_keeps_a_named_device(tmp_path, monkeypatch):
    """run_distributed spreads a process over local_mesh() only when the
    config names neither a mesh nor a device: a named device (the config's
    or the ``device`` argument's) keeps the run on that device alone."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    seen = []
    monkeypatch.setattr(TOI, "run", lambda self, **kw: seen.append((kw.get("mesh"), kw.get("device"))))
    monkeypatch.setattr(TD, "local_mesh", lambda: ("cuda:0", "cuda:1"))
    cfg = _small_config(tmp_path)
    for run_kwargs, device, want in (({"device": "cuda:1"}, None, (None, "cuda:1")),
                                     ({"device": "cuda:1"}, "cpu", (None, "cuda:1")),
                                     ({}, "cpu", (None, "cpu")),
                                     ({"mesh": 2}, "cpu", (2, "cpu")),
                                     ({}, None, (("cuda:0", "cuda:1"), None))):
        seen.clear()
        TD.run_distributed({**cfg, "run_kwargs": {"store_path": str(tmp_path / "s.h5"), **run_kwargs}}, device=device)
        assert seen == [want], (run_kwargs, device)


def test_two_process_cli_matches_single_process(tmp_path):
    """Two CLI processes over a local gloo coordinator, each on a mesh of the
    CPU twice, process 0 merging; the merged store against a single-process
    run (no mesh) passed through the same merge: every table in the same row
    order, floats at 1e-12."""
    cfg = _small_config(tmp_path)
    single = str(tmp_path / "single.h5")
    TOI(expert_loc_config=cfg["locations"], data_config=cfg["data"], model_config=cfg["model"],
        pred_loc_config=cfg["pred_loc"]).run(store_path=single, device="cpu", dtype="float64")

    multi = str(tmp_path / "multi.h5")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({**cfg, "run_kwargs": {"store_path": multi, "dtype": "float64", "mesh": 2}}))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "gpsat_tpu_torch.distributed", str(cfg_path), "--coordinator", f"localhost:{port}",
             "--num-processes", "2", "--process-id", str(h), "--device", "cpu"] + (["--merge"] if h == 0 else []),
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for h in range(2)
    ]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for h, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {h} failed:\n{out}"
    for h, n_rows in ((0, 3), (1, 3)):
        with TableStore(TD.host_store_path(multi, h), mode="r") as store:
            assert len(store.select("run_details")) == n_rows
            assert set(store.select("run_details")["device"]) == {"cpu"}

    TD.merge_stores([single], str(tmp_path / "single_merged.h5"))
    want, want_idx = _tables(str(tmp_path / "single_merged.h5"))
    got, got_idx = _tables(multi)
    assert set(got) == set(want) and got_idx == want_idx
    for t in want:
        a, b = want[t], got[t]
        assert list(a.columns) == list(b.columns) and len(a) == len(b), t
        for c in a.columns:
            if c in ("run_time", "datetime", "config"):
                continue
            if a[c].dtype.kind == "f":
                np.testing.assert_allclose(b[c].to_numpy(), a[c].to_numpy(), rtol=0, atol=1e-12, err_msg=f"{t}.{c}")
            else:
                assert b[c].tolist() == a[c].tolist(), f"{t}.{c}"
    assert len(got["preds"]) == 6 and np.isfinite(got["preds"]["f*"]).all()
