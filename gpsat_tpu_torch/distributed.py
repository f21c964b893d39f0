"""Multi-process execution of the local-expert sweep.

Port of ``gpsat_tpu/distributed.py``. Every process (one per host, or one
per card under ``torchrun``) runs the same program:

1. :func:`init_distributed` joins a ``torch.distributed`` process group over
   gloo. The group only coordinates the processes: experts are
   independent, so no collective touches a card;
2. the expert-location table is partitioned with no communication:
   process ``h`` keeps the rows whose position satisfies
   ``row % num_processes == h`` (:func:`partition_expert_locs`);
3. each process runs ``LocalExpertOI.run`` over its own devices
   (:func:`local_mesh`) into a store of its own (HDF5 has no concurrent
   writers): ``results.h5`` -> ``results.h0.h5``, ``results.h1.h5``, ...;
4. each marks its store complete with a token of the run
   (:func:`run_token`, the JAX package's hash, so both packages give a
   config the same token), and with ``merge`` process 0 waits for every
   marker and writes the merged store (:func:`merge_stores`, whose
   DataFrame part :func:`merge_frames` needs no store).

CLI (the reference's JSON-config idiom):

    python -m gpsat_tpu_torch.distributed <config.json> \\
        --coordinator <host:port> --num-processes H --process-id h \\
        [--merge] [--device cpu]

or ``torchrun --nproc-per-node=k -m gpsat_tpu_torch.distributed
<config.json> [--merge]``, whose ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` stand for the three flags; each process
then runs on its own card. :func:`dryrun_multiprocess` joins CPU processes
over gloo on any machine.
"""

from __future__ import annotations

import argparse
import glob as _glob
import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from gpsat_tpu_torch.data.store import TableStore
from gpsat_tpu_torch.utils.misc import cprint

_COMPLETE_TABLE = "_host_complete"


# --------------------------------------------------------------------------
# process topology
# --------------------------------------------------------------------------


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = 600.0,
) -> tuple:
    """Join the gloo process group (idempotent): ``(process_id,
    num_processes)``.

    The three arguments default to ``torchrun``'s environment
    (``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). With none of
    them given and none in the environment it returns ``(0, 1)`` and
    starts no group; a group that is already up is returned as it is."""
    import datetime

    import torch.distributed as dist

    env = os.environ
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return 0, 1
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("give the coordinator, the process count and the process id (or run under torchrun): "
                         f"got {coordinator_address!r}, {num_processes!r}, {process_id!r}")
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"process id {process_id} outside [0, {num_processes})")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                            rank=int(process_id), timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def local_mesh() -> tuple:
    """This process's devices: ``cuda:{LOCAL_RANK}`` when ``torchrun``
    started several processes on this host (one per card), every visible
    card otherwise."""
    import torch

    from gpsat_tpu_torch.parallel.engine import check_mesh, default_mesh

    env = os.environ
    if "LOCAL_RANK" in env and int(env.get("LOCAL_WORLD_SIZE", "1")) > 1:
        return check_mesh([torch.device("cuda", int(env["LOCAL_RANK"]))])
    return default_mesh()


# --------------------------------------------------------------------------
# expert partitioning + per-host stores
# --------------------------------------------------------------------------


def partition_expert_locs(expert_locs, num_processes: int, process_id: int):
    """Rows ``process_id::num_processes`` of the expert table: positional,
    not by index label, so every process agrees given the same table."""
    assert 0 <= process_id < num_processes, (process_id, num_processes)
    return expert_locs.iloc[process_id::num_processes].copy()


def host_store_path(store_path: str, process_id: int) -> str:
    """Per-process store file: results.h5 -> results.h0.h5 etc."""
    root, ext = os.path.splitext(store_path)
    return f"{root}.h{process_id}{ext or '.h5'}"


def run_token(config: dict, expert_locs=None) -> str:
    """A token of this run's work for the completion markers: the SHA-1 of
    the comparable config subset and of the whole (pre-partition) expert
    table, computed alike on every process with no communication, and equal
    to the JAX package's token for the same config and table. A marker of
    another config, or of a run over fewer locations, carries another token."""
    import pandas as pd

    from gpsat_tpu_torch.experts import _comparable_config_str

    h = hashlib.sha1(_comparable_config_str(config).encode())
    if expert_locs is not None:
        h.update(pd.util.hash_pandas_object(expert_locs, index=False).values.tobytes())
    return h.hexdigest()


def mark_host_complete(store_path: str, process_id: int, token: str = "") -> None:
    """Write the completion marker process 0's merge waits on."""
    import pandas as pd

    with TableStore(store_path) as store:
        store.put(_COMPLETE_TABLE, pd.DataFrame({
            "process_id": [process_id], "token": [token], "datetime": [pd.Timestamp.now().isoformat()],
        }))


def clear_host_marker(store_path: str) -> None:
    """Drop a stale completion marker before starting (new) work."""
    if not os.path.exists(store_path):
        return
    with TableStore(store_path) as store:
        store.delete(_COMPLETE_TABLE)


def host_is_complete(store_path: str, token: str = "") -> bool:
    """Whether the store carries a completion marker (of ``token``'s run,
    when given; a marker with no token column never matches one)."""
    if not os.path.exists(store_path):
        return False
    try:
        with TableStore(store_path, mode="r") as store:
            if _COMPLETE_TABLE not in store:
                return False
            if not token:
                return True
            marker = store.get(_COMPLETE_TABLE)
            return "token" in marker.columns and bool((marker["token"].astype(str) == token).any())
    except OSError:
        return False  # mid-write


def wait_for_hosts(paths: Sequence[str], timeout: float = 600.0, poll: float = 0.5, token: str = "") -> None:
    """Block until every per-process store carries its completion marker
    (of ``token``'s run); TimeoutError after ``timeout`` seconds."""
    t0 = time.monotonic()
    while True:
        missing = [p for p in paths if not host_is_complete(p, token=token)]
        if not missing:
            return
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"hosts not complete after {timeout}s: {missing}")
        time.sleep(poll)


# --------------------------------------------------------------------------
# merge
# --------------------------------------------------------------------------


def merge_frames(hosts: Sequence[Dict[str, object]], index_cols: Dict[str, list], sort: bool = True) -> dict:
    """Merge per-process tables: {table: DataFrame} for each process (index
    columns as ordinary columns) -> {table: DataFrame} merged.

    Config tables (``oi_config*``) are deduplicated on their comparable
    subset, every distinct config numbered in first-seen order over the
    processes, and each process's ``config_id`` column is renumbered
    through its own old -> new map (that of the longest config-table suffix
    its table name ends with) before the concatenation. Other tables are
    concatenated in process order and, with ``sort``, stably sorted by
    their ``index_cols`` present, then the ``_dim_*`` and ``pred_loc_*``
    columns: the merged table is then a function of the result set alone,
    whatever the number of processes. Needs pandas, not a store."""
    import pandas as pd

    from gpsat_tpu_torch.experts import _comparable_config_str

    seen: dict = {}  # comparable-config key -> merged config_id
    config_rows: dict = {}  # config table -> {key: row}
    frames: dict = {}
    for tables in hosts:
        id_maps: dict = {}  # config-table suffix -> {old id: new id}
        for t, cfg_df in tables.items():
            if not t.startswith("oi_config"):
                continue
            remap = {}
            for _, row in cfg_df.iterrows():
                key = _comparable_config_str(json.loads(row["config"]))
                if key not in seen:
                    seen[key] = len(seen)
                config_rows.setdefault(t, {}).setdefault(key, {**row, "config_id": seen[key]})
                remap[int(row["config_id"])] = seen[key]
            id_maps[t[len("oi_config"):]] = remap
        for t, df in tables.items():
            if t.startswith("oi_config") or t == _COMPLETE_TABLE:
                continue
            if "config_id" in df.columns and id_maps:
                match = max((s for s in id_maps if t.endswith(s)), key=len, default=None)
                if match is not None:
                    df = df.copy()
                    df["config_id"] = df["config_id"].map(lambda i: id_maps[match].get(int(i), int(i)))
            frames.setdefault(t, []).append(df)
    out = {}
    for t, dfs in frames.items():
        df = pd.concat(dfs, ignore_index=True)
        if sort:
            cols = [c for c in index_cols.get(t, []) if c in df.columns]
            cols += sorted(c for c in df.columns if c.startswith("_dim_"))
            cols += sorted(c for c in df.columns if c.startswith("pred_loc_"))
            if cols:
                df = df.sort_values(cols, kind="stable").reset_index(drop=True)
        out[t] = df
    for t, rows in config_rows.items():
        out[t] = pd.DataFrame(sorted(rows.values(), key=lambda r: r["config_id"]))
    return out


def merge_stores(
    host_paths: Union[str, Sequence[str]],
    out_path: str,
    sort: bool = True,
    overwrite: bool = False,
) -> List[str]:
    """Merge per-process result stores (files, or a glob pattern) into one
    store at ``out_path`` by :func:`merge_frames`; the tables keep their
    index columns. Returns the merged table names."""
    if isinstance(host_paths, str):
        host_paths = sorted(_glob.glob(host_paths))
    host_paths = list(host_paths)
    assert host_paths, "merge_stores: no host stores given"
    if os.path.exists(out_path):
        assert overwrite, f"out_path exists: {out_path} (pass overwrite=True)"
        os.remove(out_path)
    hosts, index_cols = [], {}
    for p in host_paths:
        with TableStore(p, mode="r") as store:
            tables = {}
            for t in store.keys():
                if t == _COMPLETE_TABLE:
                    continue
                tables[t] = store.select(t, set_index=False)
                if not t.startswith("oi_config"):
                    index_cols.setdefault(t, json.loads(store._h5[t].attrs["index_cols"]))
            hosts.append(tables)
    merged = merge_frames(hosts, index_cols, sort=sort)
    with TableStore(out_path) as store:
        for t, df in merged.items():
            idx = [c for c in index_cols.get(t, []) if c in df.columns]
            store.append(t, df.set_index(idx) if idx else df)
    return list(merged)


# --------------------------------------------------------------------------
# the distributed sweep
# --------------------------------------------------------------------------


def run_distributed(
    config: dict,
    *,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
    coordinator_address: Optional[str] = None,
    merge: bool = False,
    merge_timeout: float = 600.0,
    device=None,
) -> str:
    """Run one OI experiment config as this process's share of the experts.

    config: the reference-schema experiment dict (data / model / locations
    / pred_loc / run_kwargs). The process runs its partition over
    ``run_kwargs["mesh"]`` (default: :func:`local_mesh`, or
    ``run_kwargs["device"]`` alone when the config names one) into
    ``host_store_path(store_path, h)``; with ``merge``, process 0 waits for
    every process and writes the merged store at ``store_path``. ``device``
    fills ``run_kwargs["device"]`` when the config names none. Returns this
    process's store path."""
    from gpsat_tpu_torch.experts import LocalExpertOI

    pid, nproc = init_distributed(coordinator_address=coordinator_address, num_processes=num_processes,
                                  process_id=process_id)
    cprint(f"[distributed] process {pid} / {nproc}", c="OKBLUE")

    config = dict(config)
    config.pop("comment", None)
    config.pop("misc", None)
    run_kwargs = dict(config.pop("run_kwargs", {}))
    store_path = run_kwargs.pop("store_path")
    if device is not None:
        run_kwargs.setdefault("device", device)
    my_store = host_store_path(store_path, pid) if nproc > 1 else store_path

    oi = LocalExpertOI(
        expert_loc_config=config.get("locations"),
        data_config=config.get("data"),
        model_config=config.get("model"),
        pred_loc_config=config.get("pred_loc"),
    )
    token = run_token(config, oi.expert_locs)  # pre-partition: every process agrees
    if nproc > 1:
        clear_host_marker(my_store)
        oi.expert_locs = partition_expert_locs(oi.expert_locs, nproc, pid)
    if run_kwargs.get("mesh") is None and run_kwargs.get("device") is None:
        # a device the config (or ``device``) names keeps the run on it alone
        run_kwargs["mesh"] = local_mesh()
    oi.run(store_path=my_store, **run_kwargs)

    if nproc > 1:
        mark_host_complete(my_store, pid, token=token)
        if merge and pid == 0:
            paths = [host_store_path(store_path, h) for h in range(nproc)]
            wait_for_hosts(paths, timeout=merge_timeout, token=token)
            merge_stores(paths, store_path, overwrite=True)
            cprint(f"[distributed] merged {nproc} host stores -> {store_path}", c="OKGREEN")
    return my_store


# --------------------------------------------------------------------------
# multiprocess dry run (validation without a cluster)
# --------------------------------------------------------------------------


def _dryrun_worker(process_id: int, num_processes: int, port: int, shards: int) -> None:
    """One process of the dry run: join the group, fit a small f64 bucket
    over a mesh of the CPU ``shards`` times, and all-reduce the count of
    finite experts over gloo (a CPU tensor)."""
    import torch
    import torch.distributed as dist

    from gpsat_tpu_torch.models.functional import make_gpr_core
    from gpsat_tpu_torch.parallel.batching import TileBatch
    from gpsat_tpu_torch.parallel.engine import make_batched_runner, run_tile_batch

    torch.set_num_threads(1)
    pid, nproc = init_distributed(f"localhost:{port}", num_processes, process_id)
    try:
        rng = np.random.default_rng(pid)
        B, N, P, D = 2 * shards, 32, 4, 2
        X = rng.uniform(0, 4, size=(B, N, D))
        batch = TileBatch(
            X=X, y=np.sin(X[..., 0]) + 0.1 * rng.normal(size=(B, N)), mask=np.ones((B, N)),
            Xnew=rng.uniform(0, 4, size=(B, P, D)), pred_mask=np.ones((B, P)), obs_mean=np.zeros(B),
            expert_index=np.arange(B), num_obs=np.full(B, N),
        )
        core = make_gpr_core(jitter=1e-5)
        mesh = ("cpu",) * shards
        runner = make_batched_runner(core, max_iter=3, linesearch="single_eval", mesh=mesh, device="cpu")
        res = run_tile_batch(batch, {"likelihood_variance": 0.1}, runner, core, mesh=mesh, device="cpu")
        finite = torch.tensor([int((np.isfinite(res["objective"]) & np.isfinite(res["f_mean"]).all(-1)).sum())])
        dist.all_reduce(finite)
        assert int(finite) == B * nproc, f"{int(finite)} finite experts of {B * nproc}"
        print(f"dryrun process {pid}/{nproc}: OK, {len(res['expert_index'])} experts on {shards} CPU shards, "
              f"{int(finite)} finite over the group", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multiprocess(n_processes: int = 2, shards: int = 2, timeout: float = 300.0) -> None:
    """Start ``n_processes`` CPU processes, join them over gloo on a local
    coordinator, and run one meshed engine step in each."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo_root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", f"from gpsat_tpu_torch.distributed import _dryrun_worker; "
                                   f"_dryrun_worker({pid}, {n_processes}, {port}, {shards})"],
            env=env, cwd=repo_root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(n_processes)
    ]
    fail = []
    try:
        for pid, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            print(out, end="")
            if p.returncode != 0:
                fail.append(pid)
    finally:
        for p in procs:
            p.kill()  # a no-op once it has ended
    if fail:
        raise RuntimeError(f"dryrun_multiprocess: processes failed: {fail}")


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(
        prog="python -m gpsat_tpu_torch.distributed",
        description="multi-process local-expert OI (JSON config, one process per host or per card)",
    )
    ap.add_argument("config", help="experiment JSON (single config or list)")
    ap.add_argument("--coordinator", default=None, help="coordinator host:port (process 0's address)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--merge", action="store_true", help="process 0 merges the per-process stores at the end")
    ap.add_argument("--merge-timeout", type=float, default=600.0)
    ap.add_argument("--device", default=None, help="run_kwargs.device where the config names none (e.g. cpu)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from gpsat_tpu_torch.local_expert_oi import get_local_expert_oi_configs

    configs = get_local_expert_oi_configs(args.config)
    try:
        for i, cfg in enumerate(configs):
            cprint(f"--- distributed OI config {i + 1} / {len(configs)} ---", c="OKBLUE")
            run_distributed(
                cfg,
                process_id=args.process_id,
                num_processes=args.num_processes,
                coordinator_address=args.coordinator,
                merge=args.merge,
                merge_timeout=args.merge_timeout,
                device=args.device,
            )
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
