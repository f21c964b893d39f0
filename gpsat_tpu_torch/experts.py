"""LocalExpertOI — the experiment orchestrator (five batched lanes and the host-serial lane).

Port of ``gpsat_tpu/experts.py`` (ref: GPSat/local_experts.py:116-1279). It
keeps the JAX package's config surface and results schema:

  1. group experts by their global-select where-list (dynamic selects
     evaluated per expert), loading each group's observations once;
  2. compute every expert's local-selection index set and prediction
     locations on the host;
  3. assemble padded tile buckets (``parallel.batching``) and run each as
     one batched program on the card (``parallel.engine``), or as a head
     and a compacted tail of its unconverged lanes (``carry_iters``,
     ``two_stage_iters``), optionally followed by the f64 polish;
  4. write the reference-schema result tables: oi_config, expert_locs,
     run_details, preds, one table per stored hyperparameter, all
     multi-indexed by expert coordinates with an optional table_suffix.

Steps 2-3 are ``sweep``: it takes columns as a mapping of name -> array
and needs neither pandas nor h5py. ``LocalExpertOI`` wraps it with loading,
grouping, the min-obs skips and the store (pandas; ``TableStore`` on the
port's own HDF5 codec, so it runs where h5py is absent). Experts present in
run_details are skipped on a rerun, and the config is checked against the
stored oi_config, also for a store the JAX package wrote.

The compute dtype is an argument of ``run`` (``dtype``, default
``torch.float32``), as is the device (``device``, default the CUDA device);
neither is stored in the config. ``load_params`` warm-starts experts from
a results store (exact coordinate match, or ``nearest``), from direct
values, or leaves the init as it is (``previous``); ``sweep`` takes the
loaded values as arrays.

Models: exact GPR, SGPR, SVGP, VFF and ASVGP, each a batched core (VFF's
``domain_size`` is taken in raw coordinate units and divided by
``coords_scale``, as the reference's VFFModel does; the JAX orchestrator
passes it unscaled); an SVGP core whose
solver is Adam runs the Adam runner (``learning_rate``, ``check_every``,
``persistence``; ``carry_iters`` / ``two_stage_iters`` warn and are
ignored), every other core L-BFGS. ``replacement_threshold``
routes the experts with fewer observations than it to a second lane, the
replacement model's (by default the main model with other settings), which
is assembled, fitted, polished and stored on its own. A model class without
a batched core (the host models ``PureNumpyGPR``, ``SklearnGPRModel``,
``TorchGPRModel``, ``TorchKISSGPModel``, or a user's class given as
``{"path_to_model", "model_name"}``) runs on the host-serial lane: one model
object per expert (``run_host_batch``), with the batched lanes' result
tables. The route is the class's (``batched_lane``): a batched core that
fails to build raises and never falls through to the host lane.
``profile_dir`` writes a ``torch.profiler`` trace of the run there. ``mesh``
(``parallel.engine.resolve_mesh``'s forms) shards every batched lane's
buckets over devices, one host thread per shard; ``run`` spreads over every
visible card unless it is given a ``device`` or a ``mesh``. ``load_params``
and ``get_results_from_h5file`` also read reference-produced pandas-HDFStore
(PyTables) files (``data/pytables_compat``).

Behaviours of the JAX package's code kept as they are:
``load_params={"previous": True}`` leaves each batch's init unchanged (the
JAX module docstring promises the previous batch's mean optimum); the f64
polish of every lane reads the main lane's ``optim_kwargs`` (``polish``,
``polish_max_iter``, ``fixed_params``), the replacement lane's included.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import json
import os
import time
import warnings
from typing import Iterator, Optional, Union

import numpy as np
import torch

from gpsat_tpu_torch.data import dataloader as DL
from gpsat_tpu_torch.data import select as sel
from gpsat_tpu_torch.data.prediction_locations import PredictionLocations
from gpsat_tpu_torch.data import pytables_compat as PT
from gpsat_tpu_torch.data.store import TableStore
from gpsat_tpu_torch.models import (
    ASVGPModel,
    GPRModel,
    SGPRModel,
    SVGPModel,
    VFFModel,
    filter_kwargs,
    get_model,
    placement_kwargs,
    probe_model,
)
from gpsat_tpu_torch.models.asvgp import make_asvgp_core
from gpsat_tpu_torch.models.functional import ModelCore, make_gpr_core
from gpsat_tpu_torch.models.gpr import PARAM_NAMES
from gpsat_tpu_torch.models.sgpr import DEFAULT_JITTER as SGPR_JITTER
from gpsat_tpu_torch.models.sgpr import make_sgpr_core
from gpsat_tpu_torch.models.svgp import DEFAULT_JITTER as SVGP_JITTER
from gpsat_tpu_torch.models.svgp import make_svgp_core
from gpsat_tpu_torch.models.vff import make_vff_core
from gpsat_tpu_torch.ops import transforms as T
from gpsat_tpu_torch.ops.block_chol import T_BLOCK
from gpsat_tpu_torch.parallel import batching
from gpsat_tpu_torch.parallel.engine import (
    make_batched_runner,
    make_runner_for,
    polish_tile_batch,
    resolve_device,
    resolve_linesearch,
    resolve_mesh,
    run_tile_batch,  # noqa: F401  (re-exported under the JAX package's path)
    run_tile_batch_async,
    run_tile_batch_carry,
    run_tile_batch_two_stage,
)
from gpsat_tpu_torch.utils.config_func import config_func
from gpsat_tpu_torch.utils.misc import cprint, json_serializable, pandas_to_dict


@dataclasses.dataclass
class LocalExpertData:
    """Observation source + selection spec (ref: local_experts.py:43-112)."""

    obs_col: Union[str, None] = None
    coords_col: Union[list, None] = None
    global_select: Union[list, None] = None
    local_select: Union[list, None] = None
    where: Union[list, None] = None
    row_select: Union[list, None] = None
    col_select: Union[list, None] = None
    col_funcs: Union[dict, None] = None
    table: Union[str, None] = None
    data_source: object = None
    engine: Union[str, None] = None
    read_kwargs: Union[dict, None] = None

    def set_data_source(self, verbose: bool = False):
        """Normalize the data source for loading (ref: local_experts.py:68-81):
        infer the engine from a string source's suffix so later load()
        calls don't re-infer. Sources stay paths, opened per load."""
        if isinstance(self.data_source, str) and self.engine is None:
            suffix = os.path.splitext(self.data_source)[1].lower().lstrip(".")
            self.engine = DL.FILE_SUFFIX_ENGINE_MAP.get(suffix, self.engine)
            if verbose:
                print(f"set_data_source: engine={self.engine} for {self.data_source}")

    def load(self, where=None, **kwargs):
        use_where = list(self.where) if self.where is not None else None
        if where is not None:
            where = where if isinstance(where, list) else [where]
            use_where = (use_where or []) + where
        return DL.load(
            source=self.data_source,
            where=use_where,
            table=self.table,
            col_funcs=self.col_funcs,
            row_select=self.row_select,
            col_select=self.col_select,
            engine=self.engine,
            source_kwargs=self.read_kwargs,
            **kwargs,
        )


class _phase:
    """Adds the seconds spent inside the block to ``timers[name]``.

    Host phases are timed around their call sites; "device_fetch" is the
    time the host waits for a bucket's results. Under the one-deep bucket
    pipeline the card runs while the host stores the previous bucket, so the
    phases need not sum to the run's wall time ("run_wall")."""

    def __init__(self, timers: dict, name: str):
        self.timers, self.name = timers, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.timers[self.name] = self.timers.get(self.name, 0.0) + time.perf_counter() - self.t0
        return False


# the timers of the most recently started LocalExpertOI.run
_LAST_PHASES: dict = {}


def get_phase_timers() -> dict:
    """Seconds per phase of the most recently started ``LocalExpertOI.run``
    (host_load, host_select, host_assembly, host_load_params, host_store,
    device_dispatch, device_fetch, polish, host_model). Prefer the
    per-instance ``LocalExpertOI.phase_timers`` when holding the object."""
    return dict(_LAST_PHASES)


# --------------------------------------------------------------------------
# config persistence (ref: GPSat/utils.py:1136-1327)
# --------------------------------------------------------------------------


def _comparable_config_str(oi_config, skip_keys=()) -> str:
    """Canonical JSON of a config restricted to the keys config matching
    should care about: run_kwargs/misc and any skip_valid_checks_on keys
    are dropped, so a rerun that only changes e.g. store_every reuses the
    same config_id."""
    skip = set(skip_keys) | {"run_kwargs", "misc"}
    cfg = {k: v for k, v in json_serializable(oi_config).items() if k not in skip}
    return json.dumps(cfg, sort_keys=True)


def get_previous_oi_config(store_path, oi_config, skip_valid_checks_on=None, table_name="oi_config"):
    """Match the config against the stored ones; append it if new.

    Returns (prev_config, skip_valid_checks_on, config_id).
    """
    import pandas as pd

    skip_valid_checks_on = list(skip_valid_checks_on or [])
    cfg_str = json.dumps(json_serializable(oi_config), sort_keys=True)
    cmp_str = _comparable_config_str(oi_config, skip_valid_checks_on)
    with TableStore(store_path) as store:
        if table_name in store:
            prev = store.select(table_name, set_index=False)
            for _, row in prev.iterrows():
                if _comparable_config_str(json.loads(row["config"]), skip_valid_checks_on) == cmp_str:
                    return json.loads(row["config"]), skip_valid_checks_on, int(row["config_id"])
            config_id = int(prev["config_id"].max()) + 1
            prev_config = json.loads(prev.iloc[-1]["config"])
        else:
            config_id = 0
            prev_config = oi_config
        store.append(
            table_name,
            pd.DataFrame(
                {"config_id": [config_id], "datetime": [datetime.datetime.now().isoformat()], "config": [cfg_str]}
            ),
        )
    return prev_config, skip_valid_checks_on, config_id


def check_prev_oi_config(prev_oi_config, oi_config, skip_valid_checks_on=None):
    """Assert the configs agree, except for skipped keys (ref: utils.py:1276-1327)."""
    skip_valid_checks_on = list(skip_valid_checks_on or []) + ["run_kwargs", "misc"]
    prev = json_serializable(prev_oi_config)
    cur = json_serializable(oi_config)
    for k in cur.keys():
        if k in skip_valid_checks_on:
            continue
        assert json.dumps(prev.get(k), sort_keys=True) == json.dumps(cur.get(k), sort_keys=True), (
            f"config key '{k}' differs from the previously stored oi_config; "
            f"use a new store_path, delete the store, or add '{k}' to skip_valid_checks_on"
        )


# --------------------------------------------------------------------------
# the model lanes
# --------------------------------------------------------------------------

# per-tile parameters that a core's prepare_batch_init draws (the inducing
# points) or lays over the tile (VFF's domain, ASVGP's knots) for every
# expert whose load found nothing (NaN rows); a loaded row is kept
_DRAWN_PARAMS = ("inducing_points", "domain", "knots")


def _scaled_domain_size(init_params: dict):
    """VFF's ``domain_size`` (raw coordinate units, as the reference's
    VFFModel and the config take it) in the tiles' scaled units. The JAX
    orchestrator hands it to the core unscaled, so with a ``coords_scale``
    its domains are ``coords_scale`` times too wide (ROADMAP.md Queue 3)."""
    ds = init_params.get("domain_size")
    if ds is None or init_params.get("coords_scale") is None:
        return ds
    return np.asarray(ds, dtype=float).reshape(-1) / np.asarray(init_params["coords_scale"], dtype=float).reshape(-1)


_BATCHED_LANES = {"GPRModel": GPRModel, "SGPRModel": SGPRModel, "SVGPModel": SVGPModel, "VFFModel": VFFModel,
                  "ASVGPModel": ASVGPModel}


def batched_lane(model_cls) -> Optional[str]:
    """The batched lane of a model class ("GPRModel", "SGPRModel",
    "SVGPModel", "VFFModel" or "ASVGPModel": one of the five classes, or a
    class of one of their names or reference names), or None: a class
    without a batched core runs on the host-serial lane. The route is the
    class's; a failure to build its core raises and never reroutes it."""
    name = getattr(model_cls, "__name__", "")
    for lane, cls in _BATCHED_LANES.items():
        if model_cls is cls or name in (lane, f"GPflow{lane}"):
            return lane
    return None


def make_core_for_model(model_cls, kernel: str, bijectors, init_params, factor: str = "block") -> ModelCore:
    """Map a model class to its functional core (exact GPR, SGPR, SVGP, VFF
    or ASVGP). ``factor`` names the factor route of the core's pairs
    (``ops/linalg``); the SVGP core takes the default "block" route only."""
    lane = batched_lane(model_cls)
    route = {} if factor == "block" else {"factor": factor}
    if route and lane == "SVGPModel":
        raise ValueError(f"the SVGP core takes the 'block' factor route only, got {factor!r}")
    if lane == "GPRModel":
        return make_gpr_core(
            kernel=kernel,
            bijectors=bijectors_from(bijectors),
            jitter=init_params.get("jitter", 0.0),
            mean_function=init_params.get("mean_function"),
            **route,
        )
    if lane == "SGPRModel":
        # the inducing points take the identity bijector inside the core
        return make_sgpr_core(
            kernel=kernel,
            bijectors=bijectors_from(bijectors),
            jitter=init_params.get("jitter", SGPR_JITTER),
            num_inducing_points=int(init_params.get("num_inducing_points", 500)),
            train_inducing_points=bool(init_params.get("train_inducing_points", False)),
            mean_function=init_params.get("mean_function"),
            chunk_size=init_params.get("chunk_size", "auto"),
            # the port's stand-in for the JAX package's precision environment variable
            accum_precision=init_params.get("accum_precision", "highest"),
            **route,
        )
    if lane == "SVGPModel":
        return make_svgp_core(
            kernel=kernel,
            bijectors=bijectors_from(bijectors),
            jitter=init_params.get("jitter", SVGP_JITTER),
            num_inducing_points=int(init_params.get("num_inducing_points", 128)),
            likelihood=init_params.get("likelihood", "Gaussian") or "Gaussian",
            mean_function=init_params.get("mean_function"),
            train_inducing_points=bool(init_params.get("train_inducing_points", False)),
            # False | True (autodiff natural gradients) | "exact" (closed-form q)
            natural_gradients=init_params.get("natural_gradients", False),
            gamma=float(init_params.get("gamma", 0.1)),
            chunk_size=init_params.get("chunk_size", "auto"),
            accum_precision=init_params.get("accum_precision", "highest"),
            q_init=init_params.get("q_init", "auto"),
            # "auto": the collapsed bound for the Gaussian likelihood, joint
            # L-BFGS otherwise; "adam" the reference's optimiser
            solver=init_params.get("solver", "auto"),
        )
    if lane == "VFFModel":
        # the per-tile domain takes the identity bijector inside the core
        return make_vff_core(
            kernel=kernel,
            bijectors=bijectors_from(bijectors),
            num_inducing_features=int(init_params.get("num_inducing_features", 10)),
            domain_size=_scaled_domain_size(init_params),
            mean_function=init_params.get("mean_function"),
            **route,
        )
    if lane == "ASVGPModel":
        return make_asvgp_core(
            # the reference's ASVGP defaults to Matern12, not the engine's
            # generic Matern32
            kernel=init_params.get("kernel", "Matern12"),
            bijectors=bijectors_from(bijectors),
            num_inducing_features=int(init_params.get("num_inducing_features", 20)),
            margin=init_params.get("margin", 0.1),
            mean_function=init_params.get("mean_function"),
            **route,
        )
    raise ValueError(f"no batched core for model {model_cls}: it runs on the host-serial lane (lane_core)")


def bijectors_from(bij):
    """Constraint bijectors -> the full bijector map (softplus for the
    params without a constraint; ref: gpflow_models.py:416-494)."""
    out = {name: T.POSITIVE for name in PARAM_NAMES}
    if bij:
        out.update(bij)
    return out


def core_for(init_params: dict, constraints=None, model_cls=GPRModel, factor: str = "block") -> ModelCore:
    """The functional core for a model + init params + constraints, its
    pairs on the factor route ``factor``.

    Lengthscale constraints given in raw units are rescaled by coords_scale
    (ref: local_experts.py:1110-1117)."""
    ip = init_params or {}
    bijectors = None
    if constraints:
        bijectors = {}
        coords_scale = np.asarray(ip.get("coords_scale", 1.0), dtype=float).reshape(-1)
        for pname, c in constraints.items():
            low = np.asarray(c["low"], dtype=float)
            high = np.asarray(c["high"], dtype=float)
            if pname == "lengthscales" and ip.get("coords_scale") is not None:
                low = low / coords_scale
                high = high / coords_scale
            bijectors[pname] = T.interval(low, high)
    return make_core_for_model(model_cls, kernel=ip.get("kernel", "Matern32"), bijectors=bijectors, init_params=ip,
                               factor=factor)


def initial_cparams(core: ModelCore, init_params: dict, constraints, D: int) -> dict:
    """Initial constrained params from init_params, nudged inside any
    sigmoid constraint (ref: gpflow_models.py:470-479, tol 1e-2)."""
    ip = init_params or {}
    overrides = {}
    kk = ip.get("kernel_kwargs", {}) or {}
    if "lengthscales" in kk:
        overrides["lengthscales"] = kk["lengthscales"]
    if "variance" in kk:
        overrides["kernel_variance"] = kk["variance"]
    if ip.get("noise_variance") is not None:
        overrides["likelihood_variance"] = ip["noise_variance"]
    out = core.init_cparams(D, overrides=overrides)
    if ip.get("smart_init"):
        # data-driven per-tile init computed in the engine (a documented
        # divergence from the reference's fixed unit init)
        out["smart_init"] = True
    if constraints:
        coords_scale = np.asarray(ip.get("coords_scale", 1.0), dtype=float).reshape(-1)
        for pname, c in constraints.items():
            if pname not in out:
                continue
            low = np.asarray(c["low"], dtype=float)
            high = np.asarray(c["high"], dtype=float)
            if pname == "lengthscales" and ip.get("coords_scale") is not None:
                low = low / coords_scale
                high = high / coords_scale
            out[pname] = np.reshape(T.move_within_tol(out[pname], low, high, tol=1e-2), np.shape(out[pname]))
    return out


# --------------------------------------------------------------------------
# the host-serial lane: one model object per expert, for the classes without
# a batched core (gpsat_tpu/experts.py:1136-1225, 1424-1508)
# --------------------------------------------------------------------------

# init_params keys the OI layer consumes itself: scaling and de-meaning are
# applied in tile assembly, so the model must not apply them again
_HOST_RESERVED_INIT_KEYS = ("coords_scale", "obs_mean", "obs_scale", "smart_init", "jitter")


def _host_model_kwargs(init_params: dict) -> dict:
    return {k: v for k, v in init_params.items() if k not in _HOST_RESERVED_INIT_KEYS}


class _HostCore:
    """The two pieces of a ModelCore that the OI bookkeeping needs for a
    host-serial lane, ``param_names`` and ``init_cparams``, read off a
    throwaway model built on dummy data (``models.probe_model``) on
    ``device`` in ``dtype``; a class that cannot be built so falls back to
    the GPR trio."""

    num_features = None  # no factor pair for the sweep's memory cap to size

    def __init__(self, model_cls, n_dims: int, init_params: dict, optim_kwargs: dict, device=None, dtype=None):
        self.model_cls = model_cls
        self.init_params = dict(init_params or {})
        self.optim_kwargs = dict(optim_kwargs or {})
        self.device, self.dtype = device, dtype
        self._defaults = {}
        try:
            probe = probe_model(model_cls, n_dims, _host_model_kwargs(self.init_params), device=device, dtype=dtype)
            self.param_names = list(probe.param_names)
            for p in self.param_names:
                try:
                    self._defaults[p] = np.asarray(getattr(probe, f"get_{p}")(), dtype=float)
                except Exception:
                    pass
        except Exception:
            self.param_names = list(PARAM_NAMES)

    def init_cparams(self, D: int, dtype=np.float64, overrides=None) -> dict:
        out = {}
        for p in self.param_names:
            if p in self._defaults:
                out[p] = self._defaults[p].copy()
            else:
                out[p] = np.ones(D) if p == "lengthscales" else np.asarray(1.0)
        for k, v in (overrides or {}).items():
            if k in out:
                out[k] = np.reshape(np.asarray(v, dtype=float), np.shape(out[k]))
        return out


def lane_core(model_cls, init_params: dict, constraints, optim_kwargs: dict, n_dims: int, device=None,
              dtype=None, factor: str = "block"):
    """A lane's core, by class: the batched core of a class that has one
    (``core_for``), else a ``_HostCore`` for the host-serial lane."""
    if batched_lane(model_cls) is not None:
        return core_for(init_params, constraints, model_cls=model_cls, factor=factor)
    return _HostCore(model_cls, n_dims, init_params, optim_kwargs, device=device, dtype=dtype)


def _stack_param_lanes(vals: list) -> np.ndarray:
    """One parameter's per-expert values as [B, ...]; an expert whose getter
    failed (a 0-d NaN) is filled to the others' shape."""
    shapes = [np.shape(v) for v in vals if np.ndim(v)]
    tgt = shapes[0] if shapes else ()
    fixed = []
    for v in vals:
        try:
            fixed.append(np.broadcast_to(np.asarray(v, dtype=float), tgt).copy())
        except ValueError:
            fixed.append(np.full(tgt, np.nan))
    return np.stack(fixed)


def run_host_batch(batch, host_core: _HostCore, per_expert_init: dict, constraints, *, optimise: bool = True,
                   predict: bool = True) -> dict:
    """The host-serial lane's run of one tile bucket: one model per expert,
    built on its scaled, de-meaned tile (the reference's own loop, ref:
    local_experts.py:930-1260), with the init values that differ from the
    lane's defaults pushed through its setters, the constraints (bounds
    divided by coords_scale for the lengthscales) applied, then
    ``optimise_parameters`` and ``predict``. Returns the result dict of a
    batched bucket (``engine.run_tile_batch``), so that storage, restart
    and ``load_params`` treat the lanes alike. ``num_iter`` is the model's
    own count where it keeps one (``_last_opt_result.num_iter``, else
    ``_last_num_iter``), NaN where its optimiser hides it."""
    model_cls = host_core.model_cls
    ip = host_core.init_params
    model_kwargs = _host_model_kwargs(ip)
    place = placement_kwargs(model_cls, host_core.device, host_core.dtype)
    optim_kwargs = {k: v for k, v in host_core.optim_kwargs.items() if k != "fixed_params"}
    coords_scale = np.asarray(ip.get("coords_scale", 1.0), dtype=float).reshape(-1)
    D = batch.X.shape[-1]

    base = host_core.init_cparams(D)
    perx = {}
    for p, v in per_expert_init.items():
        if p == "smart_init":
            continue
        tgt = np.shape(base.get(p, np.asarray(0.0)))
        v = np.asarray(v, dtype=float)
        perx[p] = v if v.shape == (batch.B,) + tgt else np.broadcast_to(v, (batch.B,) + tgt).copy()
    scaled_constraints = {}
    for pname, c in (constraints or {}).items():
        low, high = np.asarray(c["low"], dtype=float), np.asarray(c["high"], dtype=float)
        if pname == "lengthscales" and ip.get("coords_scale") is not None:
            low, high = low / coords_scale, high / coords_scale
        scaled_constraints[pname] = {"low": low, "high": high}

    keys = ("expert_index", "num_obs", "objective", "converged", "num_iter", "stalled", "failed", "f_mean", "f_var",
            "y_var", "pred_mask", "obs_mean")
    res = {k: [] for k in keys}
    pvals = {p: [] for p in host_core.param_names}
    for j in range(batch.B):
        ei = int(batch.expert_index[j])
        if ei < 0:
            continue
        n = int(batch.num_obs[j])
        expert_loc = None if batch.expert_loc is None else np.asarray(batch.expert_loc[j], dtype=float)
        model = model_cls(
            coords=np.asarray(batch.X[j, :n]),
            obs=np.asarray(batch.y[j, :n]),
            **filter_kwargs(model_cls, {"verbose": False, "expert_loc": expert_loc, **model_kwargs}),
            **place,
        )
        # only values that differ from the lane's defaults (explicit inits,
        # constraint nudges, loaded warm starts) are set: the reference
        # passes init_params through the constructor and never sets a
        # default (ref: local_experts.py:1046-1101), which matters for
        # models with untrainable params (sklearn's fixed-alpha noise)
        for p, v in perx.items():
            if p not in host_core.param_names:
                continue
            if p in base and np.array_equal(v[j], np.asarray(base[p], dtype=float)):
                continue
            try:
                getattr(model, f"set_{p}")(v[j])
            except Exception as e:
                warnings.warn(f"host lane: set_{p} failed ({e}); using model default")
        if scaled_constraints:
            try:
                fn = model.set_parameter_constraints
                fn(scaled_constraints, **filter_kwargs(fn, {"move_within_tol": True, "tol": 1e-2}))
            except Exception as e:
                warnings.warn(f"host lane: constraints not applied ({e})")
        ok, ni = True, 0.0
        if optimise:
            try:
                ok = bool(model.optimise_parameters(**filter_kwargs(model.optimise_parameters, optim_kwargs)))
            except Exception as e:
                warnings.warn(f"host lane: optimise_parameters failed: {e}")
                ok = False
            r = getattr(model, "_last_opt_result", None)
            if r is not None and getattr(r, "num_iter", None) is not None:
                ni = float(np.asarray(r.num_iter))
            elif getattr(model, "_last_num_iter", None) is not None:
                ni = float(model._last_num_iter)
            else:
                ni = np.nan
        try:
            obj = float(model.get_objective_function_value())
        except Exception:
            obj = np.nan

        p_count = int(batch.pred_mask[j].sum())
        fm, fv, yv = (np.zeros(batch.Pmax) for _ in range(3))
        if predict and p_count:
            pred = model.predict(coords=np.asarray(batch.Xnew[j, :p_count]),
                                 **filter_kwargs(model.predict, {"apply_scale": False}))
            fm[:p_count] = np.asarray(pred["f*"], dtype=float).reshape(-1)
            fv[:p_count] = np.asarray(pred["f*_var"], dtype=float).reshape(-1)
            if "y_var" in pred:
                yv[:p_count] = np.asarray(pred["y_var"], dtype=float).reshape(-1)
            else:
                # no noisy-prediction variance (sklearn): add the likelihood
                # variance where the model exposes it
                try:
                    nv = float(np.ravel(model.get_likelihood_variance())[0])
                except Exception:
                    nv = 0.0
                yv[:p_count] = fv[:p_count] + nv
        r = getattr(model, "_last_opt_result", None)
        stalled = getattr(r, "stalled", None)
        for k, v in zip(keys, (ei, n, obj, ok, ni, bool(np.asarray(stalled)) if stalled is not None else False,
                               not np.isfinite(obj), fm, fv, yv, np.asarray(batch.pred_mask[j], dtype=float),
                               float(batch.obs_mean[j]))):
            res[k].append(v)
        for p in host_core.param_names:
            try:
                pvals[p].append(np.asarray(getattr(model, f"get_{p}")(), dtype=float))
            except Exception:
                pvals[p].append(np.asarray(np.nan))
    out = {k: np.asarray(v) for k, v in res.items()}
    out.update({p: _stack_param_lanes(v) for p, v in pvals.items() if v})
    return out


def check_optim_kwargs(optim_kwargs: dict, dtype=torch.float32, optimise: bool = True):
    """Raise ValueError for a line search name outside
    ``optim.lbfgs.LINESEARCHES``. A predict-only run searches nothing, and
    ``carry_iters`` runs its head and tail with the single-eval search
    whatever ``linesearch`` says, as the JAX package does."""
    if optimise and not optim_kwargs.get("carry_iters"):
        resolve_linesearch(optim_kwargs.get("linesearch"), dtype)


def _compaction(core, optim_kwargs, runner, *, fixed, optimise, pad_multiple, dev, mesh):
    """``(batch, init) -> results`` for a bucket run as a head on the whole
    batch and a compacted tail of its unconverged lanes, or None.

    ``carry_iters`` K: the head stops after K iterations and the tail
    resumes its L-BFGS state (``run_tile_batch_carry``, single-eval; head and
    tail share memory_size, the state's history length). ``two_stage_iters``
    K: the tail, the sweep's own runner, restarts from the head's optima
    (``run_tile_batch_two_stage``)."""
    memory_size = int(optim_kwargs.get("memory_size", 10))
    carry_k, two_k = optim_kwargs.get("carry_iters"), optim_kwargs.get("two_stage_iters")
    if carry_k:
        kw = dict(fixed_params=fixed, optimise=optimise, linesearch="single_eval", memory_size=memory_size,
                  return_state=True, mesh=mesh, device=dev)
        head = make_batched_runner(core, max_iter=int(carry_k), **kw)
        tail = make_batched_runner(core, max_iter=int(optim_kwargs.get("max_iter", 10_000)), take_state=True, **kw)
        return functools.partial(run_tile_batch_carry, runner_head=head, runner_tail=tail, core=core,
                                 mesh=mesh, pad_multiple=pad_multiple, device=dev)
    if two_k:
        head = make_batched_runner(
            core, fixed_params=fixed, max_iter=int(two_k), optimise=optimise,
            linesearch=optim_kwargs.get("linesearch"),
            max_linesearch_steps=int(optim_kwargs.get("max_linesearch_steps", 32)),
            memory_size=memory_size, mesh=mesh, device=dev,
        )
        return functools.partial(run_tile_batch_two_stage, runner_head=head, runner_tail=runner, core=core,
                                 mesh=mesh, pad_multiple=pad_multiple, device=dev)
    return None


def _bucket_init(init_cparams: dict, loaded: Optional[dict], expert_index: np.ndarray) -> dict:
    """A bucket's initial params: the shared init, and where ``loaded`` is
    given, per-expert rows of it ([E, ...] by expert, NaN where nothing was
    loaded) over the shared values. A drawn per-tile parameter (the
    inducing points) keeps NaN rows where nothing was loaded, for the core
    to draw (the JAX package leaves the shared zeros there). Loading drops
    ``smart_init``, as the JAX package's load does."""
    if loaded is None:
        return init_cparams
    out = {k: v for k, v in init_cparams.items() if k != "smart_init"}
    live = np.flatnonzero(expert_index >= 0)
    for k, vals in loaded.items():
        if k not in out:
            continue
        shared = np.asarray(out[k], dtype=float)
        per = np.broadcast_to(np.nan if k in _DRAWN_PARAMS else shared, (len(expert_index),) + shared.shape).copy()
        rows = np.asarray(vals, dtype=float)[expert_index[live]].reshape((len(live),) + shared.shape)
        ok = ~np.isnan(rows.reshape(len(live), -1)).any(axis=1)
        per[live[ok]] = rows[ok]
        out[k] = per
    return out


@dataclasses.dataclass
class _Lane:
    """One model lane of a sweep: its core, runner and compaction, and the
    init params, constraints and stored ``loaded_params`` its experts use."""

    name: str  # "main" or "replacement"
    model: str  # the model class's name, as run_details names it
    core: ModelCore
    runner: object
    compaction: object
    init_params: dict
    constraints: Optional[dict]
    loaded: Optional[dict]


def _make_lane(name, model, init_params, constraints, optim_kwargs, loaded, *, n_dims, dtype, optimise,
               pad_multiple, dev, mesh) -> _Lane:
    model = get_model(model) if isinstance(model, str) else model
    ip = init_params or {}
    core = lane_core(model, ip, constraints, optim_kwargs, n_dims, device=dev, dtype=dtype)
    if isinstance(core, _HostCore):
        # one model per expert: no runner, no compaction
        return _Lane(name, getattr(model, "__name__", str(model)), core, None, None, ip, constraints, loaded)
    fixed = tuple(dict.fromkeys(tuple(optim_kwargs.get("fixed_params", ())) + tuple(core.default_fixed_params)))
    if core.optimizer == "adam":
        for k in ("two_stage_iters", "carry_iters"):
            if optim_kwargs.get(k):
                warnings.warn(f"{k} only applies to L-BFGS-optimized cores; ignored for {core.name}")
        runner = make_runner_for(
            core,
            fixed_params=fixed,
            max_iter=int(optim_kwargs.get("max_iter", 2000)),
            optimise=optimise,
            learning_rate=float(optim_kwargs.get("learning_rate", 1e-2)),
            check_every=int(optim_kwargs.get("check_every", 10)),
            persistence=int(optim_kwargs.get("persistence", 100)),
            mesh=mesh,
            device=dev,
        )
        return _Lane(name, getattr(model, "__name__", str(model)), core, runner, None, ip, constraints, loaded)
    check_optim_kwargs(optim_kwargs, dtype, optimise)
    for k in ("learning_rate", "check_every", "persistence"):
        if optim_kwargs.get(k) is not None:
            # only SVGP cores have an Adam path to point at
            hint = " (set init_params solver='adam' to force the Adam path)" if core.name.startswith("SVGP") else ""
            warnings.warn(f"{k} only applies to Adam-optimized cores; ignored for {core.name}{hint}")
    runner = make_runner_for(
        core,
        fixed_params=fixed,
        max_iter=int(optim_kwargs.get("max_iter", 10_000)),
        optimise=optimise,
        linesearch=optim_kwargs.get("linesearch"),
        max_linesearch_steps=int(optim_kwargs.get("max_linesearch_steps", 32)),
        memory_size=int(optim_kwargs.get("memory_size", 10)),
        mesh=mesh,
        device=dev,
    )
    compaction = _compaction(core, optim_kwargs, runner, fixed=fixed, optimise=optimise, pad_multiple=pad_multiple,
                             dev=dev, mesh=mesh)
    return _Lane(name, getattr(model, "__name__", str(model)), core, runner, compaction, ip, constraints, loaded)


def _factor_width(core: ModelCore, D: int) -> Optional[int]:
    """The padded width of an inter-domain core's factor pairs (its feature
    count, identity-padded to kernel 1's block), or None."""
    if core.num_features is None:
        return None
    return batching.round_up(core.num_features(D), T_BLOCK)


def sweep(
    columns,
    expert_locs,
    *,
    coords_col: list,
    obs_col,
    local_select: Optional[list],
    pred_loc: PredictionLocations,
    model=GPRModel,
    init_params: Optional[dict] = None,
    constraints: Optional[dict] = None,
    optim_kwargs: Optional[dict] = None,
    replacement_threshold: Optional[int] = None,
    replacement_model=None,
    replacement_init_params: Optional[dict] = None,
    replacement_constraints: Optional[dict] = None,
    replacement_optim_kwargs: Optional[dict] = None,
    optimise: bool = True,
    predict: bool = True,
    min_obs: int = 3,
    max_batch_size: Optional[int] = None,
    pad_multiple: Optional[int] = None,
    loaded_params: Optional[dict] = None,
    replacement_loaded_params: Optional[dict] = None,
    dtype=torch.float32,
    device=None,
    mesh=None,
    timers: Optional[dict] = None,
    index: Optional[str] = None,
) -> Iterator[dict]:
    """Fit and predict every expert of ``expert_locs`` on ``columns``.

    ``columns`` and ``expert_locs`` are DataFrames or mappings of column
    name -> array; nothing here imports pandas or h5py. The sweep runs local
    selection, prediction locations, tile assembly, then each bucket on
    ``device`` in ``dtype`` and, with ``optim_kwargs["polish"]`` "f64" (or
    True), the f64 polish on the same device. ``optim_kwargs["carry_iters"]``
    or ``["two_stage_iters"]`` run each bucket as a head and a compacted tail
    (host-synchronous: the tail depends on the head's results), whose result
    adds "compaction" (the engine's widths and iterations of each part).

    ``model`` (a class of ``models.get_model``, its name, or any class with
    the BaseGPRModel contract) picks the lane: the batched core of one of
    the five classes that have one, else the host-serial lane, which builds
    one model per expert on the f64 tiles (``run_host_batch``; no polish,
    device and dtype passed to a constructor that names them).
    With ``replacement_threshold``, the experts with fewer observations than
    it run in a second lane: ``replacement_model``, ``_init_params`` and
    ``_constraints`` default to the main lane's, ``replacement_optim_kwargs``
    to none (the JAX package's defaults). Each lane is assembled, fitted and
    polished on its own (the polish with the lane's core and the main
    lane's ``optim_kwargs``); dense exact-GPR buckets are capped by
    ``batching.auto_batch_cap`` at their width, VFF and ASVGP buckets at
    their factor pairs' padded width.

    ``loaded_params`` (name -> [E, ...] aligned with the rows of
    ``expert_locs``) warm-starts each main-lane expert from its row, and
    ``replacement_loaded_params`` each replacement-lane expert; a row
    holding a NaN keeps the shared init (the inducing points are drawn,
    VFF's domain and ASVGP's knots laid over the tile).
    ``LocalExpertOI`` fills them from ``load_params``.

    ``mesh`` (``parallel.engine.resolve_mesh``'s forms; None: ``device`` alone)
    shards every batched lane's buckets, their compaction and their polish
    over its devices; the host-serial lane stays on ``device`` (default: the
    mesh's first device). Tiles are capped by the free memory of the mesh's
    first device.

    ``index`` picks the radius queries' arm for local selection and the
    prediction locations: "grid", the host library's grid-hash index, or
    "kdtree", scipy's (the plain version); both give the same tiles. None
    (the default): "grid" for local selection, ``pred_loc.index`` (itself
    "grid" by default) for the prediction locations.

    It yields, first, the experts skipped for fewer than ``min_obs``
    observations (or no prediction location) as ``{"skipped": True,
    "expert_index", "num_obs"}``, then one result dict per bucket, the main
    lane's first: the engine's keys, ``lane`` ("main" or "replacement"),
    ``model`` (the lane's model class name), ``pred_coords`` (each expert's
    raw [P_i, D] prediction coordinates), ``batch_s`` (seconds from
    dispatch to result) and, after the polish, ``coarse`` (the result in
    ``dtype`` it started from). ``expert_index`` counts rows of
    ``expert_locs``. Buckets run one deep: a bucket's result is yielded
    after the next bucket is dispatched. Seconds per phase accumulate into
    ``timers``.
    """
    mesh = resolve_mesh(mesh, device)
    dev = mesh[0] if device is None else resolve_device(device)
    optim_kwargs = dict(optim_kwargs or {})
    timers = {} if timers is None else timers
    lane_kw = dict(n_dims=len(coords_col), dtype=dtype, optimise=optimise, pad_multiple=pad_multiple, dev=dev,
                   mesh=mesh)
    lanes = [_make_lane("main", model, init_params, constraints, optim_kwargs, loaded_params, **lane_kw)]
    if replacement_threshold is not None:
        lanes.append(_make_lane(
            "replacement",
            model if replacement_model is None else replacement_model,
            init_params if replacement_init_params is None else replacement_init_params,
            constraints if replacement_constraints is None else replacement_constraints,
            dict(replacement_optim_kwargs or {}),
            replacement_loaded_params,
            **lane_kw,
        ))
    polish = optimise and optim_kwargs.get("polish") in ("f64", True)

    obs_name = obs_col if isinstance(obs_col, str) else obs_col[0]
    E = sel.num_rows(expert_locs)
    with _phase(timers, "host_select"):
        sel_ix = sel.local_select_indices_all(columns, expert_locs, local_select or [], index=index or "grid")
        pcs = pred_loc.batch_call(expert_locs, index=index) if predict else [np.zeros((0, len(coords_col)))] * E
    run = [e for e in range(E) if len(sel_ix[e]) >= min_obs and not (predict and len(pcs[e]) == 0)]
    if len(run) < E:
        skipped = np.setdiff1d(np.arange(E), run)
        yield {"skipped": True, "expert_index": skipped, "num_obs": np.asarray([len(sel_ix[e]) for e in skipped])}
    if not run:
        return
    # data-poor experts go to the replacement lane
    if replacement_threshold is not None:
        thr = int(replacement_threshold)
        lane_rows = [[e for e in run if len(sel_ix[e]) >= thr], [e for e in run if len(sel_ix[e]) < thr]]
    else:
        lane_rows = [run]

    obs_coords = sel.columns_array(columns, coords_col)
    obs_vals = np.asarray(columns[obs_name], dtype=float)
    loc_coords = sel.columns_array(expert_locs, coords_col)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64

    def finish(fin, batch, t0, lane):
        with _phase(timers, "device_fetch"):
            res = fin()
        if polish and lane.runner is not None:
            with _phase(timers, "polish"):
                coarse = res
                res = polish_tile_batch(
                    batch, coarse, lane.core,
                    max_iter=int(optim_kwargs.get("polish_max_iter", 150)),
                    fixed_params=tuple(optim_kwargs.get("fixed_params", ())),
                    mesh=mesh,
                    device=dev,
                )
            res["coarse"] = coarse
        res["lane"], res["model"] = lane.name, lane.model
        res["pred_coords"] = [pcs[int(e)] for e in res["expert_index"]]
        res["batch_s"] = time.perf_counter() - t0
        return res

    pending = None
    for lane, rows in zip(lanes, lane_rows):
        if not rows:
            continue
        ip = lane.init_params
        with _phase(timers, "host_assembly"):
            tiles = batching.assemble_tiles(
                obs_coords,
                obs_vals,
                [sel_ix[e] for e in rows],
                [pcs[e] for e in rows],
                expert_index=np.asarray(rows),
                expert_locs=loc_coords[rows],
                coords_scale=ip.get("coords_scale"),
                obs_mean=ip.get("obs_mean"),
                max_batch_size=max_batch_size,
                # dense exact GPR keeps ~8 [B, Nmax, Nmax] buffers live, an
                # inter-domain core as many [B, W, W] of its padded feature
                # count W; a sparse core's working set is O(B M (M + C)): no cap
                memory_cap=lane.runner is not None and (lane.core.name.startswith("GPR[")
                                                        or lane.core.num_features is not None),
                cap_width=_factor_width(lane.core, len(coords_col)),
                device=mesh[0],
            )
        init_cparams = initial_cparams(lane.core, ip, lane.constraints, len(coords_col))
        for b in tiles:
            t0 = time.perf_counter()
            init = _bucket_init(init_cparams, lane.loaded, b.expert_index)
            # tiles are assembled in f64; the polish re-fits from them
            cast = batching.cast_batch(b, np_dtype)
            if lane.runner is None:
                # the host-serial lane runs the bucket's models one by one on
                # the f64 tiles, each on the sweep's device in its dtype
                with _phase(timers, "host_model"):
                    host_res = run_host_batch(b, lane.core, init, lane.constraints, optimise=optimise,
                                              predict=predict)
                fin = functools.partial(dict, host_res)
            elif lane.compaction is not None:
                # runs whole when finish() asks for it, after the previous bucket
                fin = functools.partial(lane.compaction, cast, init)
            else:
                with _phase(timers, "device_dispatch"):
                    fin = run_tile_batch_async(cast, init, lane.runner, lane.core, mesh=mesh,
                                               pad_multiple=pad_multiple, device=dev)
            if pending is not None:
                yield finish(*pending)  # the host stores it while the card runs b
            pending = (fin, b, t0, lane)
    yield finish(*pending)


# --------------------------------------------------------------------------
# orchestrator
# --------------------------------------------------------------------------


class LocalExpertOI:
    """Config-driven local-expert OI experiment (batched, on one card or a mesh of devices)."""

    def __init__(
        self,
        expert_loc_config: Optional[dict] = None,
        data_config: Optional[dict] = None,
        model_config: Optional[dict] = None,
        pred_loc_config: Optional[dict] = None,
        local_expert_config=None,
    ):
        if local_expert_config is not None:
            expert_loc_config = local_expert_config.expert_locs_config
            data_config = local_expert_config.data_config
            model_config = local_expert_config.model_config
            pred_loc_config = local_expert_config.prediction_locs_config

        # config dataclasses are accepted as well as dicts
        def as_dict(cfg):
            return cfg.to_dict() if hasattr(cfg, "to_dict") else cfg

        self.config = {}
        self.expert_locs = None
        self.data = None
        self.model = None
        self.phase_timers = {}

        self.set_expert_locations(**(as_dict(expert_loc_config) or {}))
        self.set_data(**(as_dict(data_config) or {}))
        self.set_model(**(as_dict(model_config) or {}))
        self.set_pred_loc(**(as_dict(pred_loc_config) or {}))

    # ---- setters (config capture mirrors _method_inputs_to_config) ----
    def set_expert_locations(
        self,
        df=None,
        file=None,
        source=None,
        where=None,
        col_funcs=None,
        keep_cols=None,
        col_select=None,
        row_select=None,
        sort_by=None,
        reset_index=False,
        source_kwargs=None,
        verbose=False,
        **kwargs,
    ):
        cfg = {k: v for k, v in locals().items() if k not in ("self", "kwargs") and v is not None}
        cfg.update(kwargs)
        self.config["locations"] = json_serializable(cfg)

        if col_select is None and keep_cols is not None:
            col_select = keep_cols
        if source is None:
            source = df if df is not None else file
        if source is None:
            return None

        locs = DL.load(
            source=source,
            where=where,
            source_kwargs=source_kwargs,
            col_funcs=col_funcs,
            row_select=row_select,
            col_select=col_select,
            reset_index=reset_index,
            verbose=verbose,
            **kwargs,
        )
        if sort_by:
            locs = locs.sort_values(sort_by)
        self.expert_locs = locs

    def set_data(self, **kwargs):
        self.config["data"] = json_serializable({k: v for k, v in kwargs.items() if v is not None})
        self.data = LocalExpertData(**kwargs)

    def set_model(
        self,
        oi_model=None,
        init_params=None,
        constraints=None,
        load_params=None,
        optim_kwargs=None,
        pred_kwargs=None,
        params_to_store=None,
        replacement_threshold=None,
        replacement_model=None,
        replacement_init_params=None,
        replacement_constraints=None,
        replacement_optim_kwargs=None,
        replacement_pred_kwargs=None,
    ):
        cfg = {k: v for k, v in locals().items() if k != "self" and v is not None}
        self.config["model"] = json_serializable(cfg)

        self.oi_model_name = oi_model if isinstance(oi_model, str) else getattr(oi_model, "__name__", str(oi_model))
        if isinstance(oi_model, str):
            self.model = get_model(oi_model)
        elif isinstance(oi_model, dict):
            # a user's class: {"path_to_model": module, "model_name": class},
            # the module found on sys.path with path_to_model appended to it
            import importlib
            import sys

            sys.path.append(oi_model["path_to_model"])
            module = importlib.import_module(oi_model["path_to_model"])
            self.model = getattr(module, oi_model["model_name"])
        else:
            self.model = oi_model
        self.model_init_params = init_params or {}
        self.constraints = constraints
        self.model_load_params = load_params
        self.optim_kwargs = optim_kwargs or {}
        self.pred_kwargs = pred_kwargs or {}
        self.params_to_store = None if params_to_store == "all" else params_to_store

        # data-poor experts go to the replacement model, with the JAX
        # package's defaults (ref: local_experts.py:339-346)
        self.replacement_threshold = replacement_threshold
        if replacement_threshold is not None:
            self.replacement_model = self.model if replacement_model is None else get_model(replacement_model)
            self.replacement_init_params = (
                self.model_init_params if replacement_init_params is None else replacement_init_params
            )
            self.replacement_constraints = self.constraints if replacement_constraints is None else replacement_constraints
            self.replacement_optim_kwargs = replacement_optim_kwargs or {}
            self.replacement_pred_kwargs = replacement_pred_kwargs or {}

    def set_pred_loc(self, **kwargs):
        self.config["pred_loc"] = json_serializable({k: v for k, v in kwargs.items() if v is not None})
        self.pred_loc = PredictionLocations(**kwargs)
        if isinstance(self.data, LocalExpertData) and self.data.coords_col is not None:
            self.pred_loc.coords_col = self.data.coords_col

    # ---- helpers ----
    @staticmethod
    def _remove_previously_run_locations(store_path, xprt_locs, table="run_details"):
        if not os.path.exists(store_path):
            return xprt_locs
        with TableStore(store_path) as store:
            if table not in store:
                return xprt_locs
            prev = store.select(table)
            idx_names = [n for n in prev.index.names if n is not None]
            if not idx_names:
                return xprt_locs
            prev = prev.reset_index()[idx_names].drop_duplicates()
        tmp = xprt_locs.merge(prev, how="left", on=idx_names, indicator="found_already")
        keep = (tmp["found_already"] == "left_only").values
        cprint(f"for table: {table} keeping {keep.sum()} / {len(keep)} expert locations", c="OKCYAN")
        return xprt_locs.loc[keep].copy()


    # ---- the sweep ----
    def run(self, *args, **kwargs):
        """Run the sweep (see _run for the full signature). Seconds per
        phase accumulate into a fresh ``self.phase_timers`` for each call."""
        global _LAST_PHASES
        self.phase_timers = _LAST_PHASES = {}
        return self._run(*args, **kwargs)

    def _run(
        self,
        store_path: str = None,
        store_every: int = 10,
        check_config_compatible: bool = True,
        skip_valid_checks_on=None,
        optimise: bool = True,
        predict: bool = True,
        min_obs: int = 3,
        table_suffix: str = "",
        mesh=None,
        max_batch_size: Optional[int] = None,
        pad_multiple: Optional[int] = None,
        profile_dir: Optional[str] = None,
        device=None,
        dtype=torch.float32,
    ):
        """``mesh`` (``parallel.engine.resolve_mesh``'s JSON forms: "all",
        True, an int, a list of devices) shards every batched lane over
        devices; with neither ``mesh`` nor ``device`` the run spreads over
        every visible card, as the JAX package's default mesh does, and an
        explicit ``device`` (default: the CUDA device, which must exist)
        keeps one device. ``dtype`` (``torch.float32`` or
        ``torch.float64``, or their names) stands where the JAX package's
        ``jax_enable_x64`` does. None of the three is stored in the config;
        the results' ``device`` column names the mesh's first device."""
        import pandas as pd

        self.config["run_kwargs"] = json_serializable(
            dict(
                store_path=store_path,
                store_every=store_every,
                check_config_compatible=check_config_compatible,
                skip_valid_checks_on=skip_valid_checks_on,
                optimise=optimise,
                predict=predict,
                min_obs=min_obs,
                table_suffix=table_suffix,
            )
        )
        t_start = time.perf_counter()
        timers = self.phase_timers

        # every refusal comes before the store is touched
        mesh = resolve_mesh("all" if mesh is None and device is None else mesh, device)
        if profile_dir is not None:
            # a torch.profiler trace of the whole run under profile_dir
            # (the JAX package writes a jax.profiler trace there)
            from gpsat_tpu_torch.decorators import profile_trace

            with profile_trace(profile_dir):
                return self._run(
                    store_path=store_path, store_every=store_every, check_config_compatible=check_config_compatible,
                    skip_valid_checks_on=skip_valid_checks_on, optimise=optimise, predict=predict, min_obs=min_obs,
                    table_suffix=table_suffix, mesh=mesh, max_batch_size=max_batch_size, pad_multiple=pad_multiple,
                    device=device, dtype=dtype,
                )
        dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        dev = mesh[0] if device is None else resolve_device(device)
        check_optim_kwargs(self.optim_kwargs, dtype, optimise)
        # each lane's model, init params, constraints and optim_kwargs; the
        # replacement lane's settings are checked here too, before the store
        # is touched
        lane_cfg = {"main": (self.model, self.model_init_params, self.constraints, self.optim_kwargs)}
        repl_kw = {}
        if self.replacement_threshold is not None:
            check_optim_kwargs(self.replacement_optim_kwargs, dtype, optimise)
            lane_cfg["replacement"] = (self.replacement_model, self.replacement_init_params,
                                       self.replacement_constraints, self.replacement_optim_kwargs)
            repl_kw = dict(
                replacement_threshold=self.replacement_threshold,
                replacement_model=self.replacement_model,
                replacement_init_params=self.replacement_init_params,
                replacement_constraints=self.replacement_constraints,
                replacement_optim_kwargs=self.replacement_optim_kwargs,
            )
        n_dims = len(self.data.coords_col) if self.data is not None and self.data.coords_col else 0
        lane_cores = {lane: lane_core(*cfg, n_dims, device=dev, dtype=dtype) for lane, cfg in lane_cfg.items()}
        assert isinstance(self.expert_locs, pd.DataFrame), "expert_locs must be a DataFrame — call set_expert_locations"
        assert self.data is not None and self.data.data_source is not None, "'data_source' is None"
        assert self.model is not None, "'model' is None — call set_model"
        assert isinstance(store_path, str), f"store_path expected str, got: {type(store_path)}"
        min_obs = max(int(min_obs), 1)

        if os.path.dirname(store_path):
            os.makedirs(os.path.dirname(store_path), exist_ok=True)

        coords_col = self.data.coords_col

        # --- config id / compat ---
        prev_cfg, skip_checks, config_id = get_previous_oi_config(
            store_path, self.config, skip_valid_checks_on, table_name=f"oi_config{table_suffix}"
        )
        if check_config_compatible:
            check_prev_oi_config(prev_cfg, self.config, skip_checks)

        # --- expert locations bookkeeping ---
        store_locs = self._remove_previously_run_locations(
            store_path, self.expert_locs.copy(), table=f"expert_locs{table_suffix}"
        )
        if len(store_locs):
            with TableStore(store_path) as store:
                store.append(f"expert_locs{table_suffix}", store_locs.set_index(coords_col))

        xprt_locs = self._remove_previously_run_locations(
            store_path, self.expert_locs.copy(), table=f"run_details{table_suffix}"
        )
        if len(xprt_locs) == 0:
            cprint("all expert locations already run; nothing to do", c="OKGREEN")
            return None

        # --- group experts by their (dynamic) global-select where list ---
        groups = {}
        for i in range(len(xprt_locs)):
            where = sel.get_where_list(
                self.data.global_select or [], local_select=self.data.local_select, ref_loc=xprt_locs.iloc[[i]]
            )
            key = json.dumps(json_serializable(where), sort_keys=True, default=str)
            groups.setdefault(key, {"where": where, "rows": []})
            groups[key]["rows"].append(i)

        lane_init = {lane: initial_cparams(lane_cores[lane], ip, cons, len(coords_col))
                     for lane, (_, ip, cons, _) in lane_cfg.items()}
        device_name = torch.cuda.get_device_name(mesh[0]) if mesh[0].type == "cuda" else "cpu"
        model_name = f"gpsat_tpu_torch.{getattr(self.model, '__name__', str(self.model))}"
        total = len(xprt_locs)
        done = 0
        for grp in groups.values():
            with _phase(timers, "host_load"):
                df = self.data.load(where=grp["where"] if grp["where"] else None, reset_index=True)
            rows = np.asarray(grp["rows"])
            with _phase(timers, "host_load_params"):
                loaded = {
                    lane: self._load_params_for_experts(
                        xprt_locs.iloc[rows], coords_col, lane_init[lane], core, store_path
                    )
                    for lane, core in lane_cores.items()
                }
            if any(v is False for v in loaded.values()):
                continue  # load failure policy: skip these experts
            results = sweep(
                df,
                xprt_locs.iloc[rows],
                coords_col=coords_col,
                obs_col=self.data.obs_col,
                local_select=self.data.local_select,
                pred_loc=self.pred_loc,
                model=self.model,
                init_params=self.model_init_params,
                constraints=self.constraints,
                optim_kwargs=self.optim_kwargs,
                **repl_kw,
                optimise=optimise,
                predict=predict,
                min_obs=min_obs,
                max_batch_size=max_batch_size,
                pad_multiple=pad_multiple,
                loaded_params=loaded["main"],
                replacement_loaded_params=loaded.get("replacement"),
                dtype=dtype,
                device=dev,
                mesh=mesh,
                timers=timers,
            )
            for res in results:
                eis = rows[res["expert_index"]]
                with _phase(timers, "host_store"):
                    if res.get("skipped"):
                        # record min-obs skips so restarts don't retry them
                        # (ref: local_experts.py:988-1012)
                        n = len(eis)
                        tables = {
                            f"run_details{table_suffix}": self._run_details_rows(
                                xprt_locs, eis, coords_col, num_obs=res["num_obs"], run_time=np.full(n, np.nan),
                                objective=np.full(n, np.nan), optimised=optimise, success=np.zeros(n, dtype=bool),
                                num_iter=np.zeros(n), stalled=np.zeros(n, dtype=bool), model_name=model_name,
                                device_name="", config_id=config_id,
                            )
                        }
                    else:
                        # run_details names the lane's model
                        tables = self._result_tables(
                            {**res, "expert_index": eis}, lane_cores[res["lane"]].param_names, xprt_locs,
                            coords_col, table_suffix, optimise, f"gpsat_tpu_torch.{res['model']}", device_name,
                            config_id, predict,
                        )
                    with TableStore(store_path) as store:
                        for name, frame in tables.items():
                            store.append(name, frame)
                done += len(eis)
                if not res.get("skipped"):
                    cprint(f"{done} / {total} experts done ({res['batch_s']:.2f}s for batch of {len(eis)})",
                           c="OKCYAN")

        timers["run_wall"] = time.perf_counter() - t_start
        split = ", ".join(f"{k} {v:.2f}s" for k, v in sorted(timers.items()))
        cprint(f"phases: {split}", c="OKBLUE")
        cprint(f"'run': {timers['run_wall']:.3f} seconds", c="OKGREEN")
        return None

    # ---- parameter loading (ref: local_experts.py:553-689) ----
    _LOAD_RESERVED = ("file", "table_suffix", "previous", "previous_params", "param_names", "index_adjust")

    def _load_params_for_experts(self, xprt_locs, coords_col, init_cparams, core, store_path):
        """``load_params`` for a group of experts: the ``loaded_params`` of
        ``sweep`` (name -> [E, ...] aligned with ``xprt_locs``'s rows, NaN
        where nothing is loaded), None to keep the init, or False when the
        file does not exist (a warning; the experts are skipped, as the JAX
        package skips the bucket).

        - ``previous``: the init unchanged (the JAX package's code; its
          docstring's "previous batch's mean optimum" is not implemented).
        - direct values without ``file``: the same values for every expert
          (keys that are no parameter are ignored).
        - ``file`` (default: the run's store) and ``table_suffix``: each
          parameter table, matched on the expert coordinates exactly or,
          with ``nearest``, at the closest stored expert; a stored row with
          a NaN is not loaded.

        The file is read once per group of experts, before the group's
        sweep: with ``nearest`` reading the run's own store, the experts of
        the same group's earlier buckets are not yet there (the JAX package
        reads it again before each bucket)."""
        lp = self.model_load_params
        if not lp or lp.get("previous", False):
            return None
        E = len(xprt_locs)
        direct = {k: v for k, v in lp.items() if k not in self._LOAD_RESERVED}
        if direct and "file" not in lp:
            return {
                k: np.broadcast_to(np.reshape(np.asarray(v, dtype=float), np.shape(init_cparams[k])),
                                   (E,) + np.shape(init_cparams[k]))
                for k, v in direct.items() if k in init_cparams
            }
        file = lp.get("file", store_path)
        suffix = lp.get("table_suffix", "")
        if not os.path.exists(file):
            warnings.warn(f"load_params file does not exist: {file}")
            return False
        locs = np.stack([xprt_locs[c].to_numpy() for c in coords_col], axis=1)
        out = {}
        # the port's TableStore, or a reference-produced PyTables store
        with PT.open_store(file) as store:
            for pname in core.param_names:
                tbl = f"{pname}{suffix}"
                if tbl not in store:
                    continue
                pdf = store.select(tbl).reset_index()
                dim_cols = sorted(c for c in pdf.columns if c.startswith("_dim_"))
                pdf = pdf.sort_values(list(coords_col) + dim_cols, kind="stable")
                keys = pdf[coords_col].to_numpy()
                vals = pdf[pname].to_numpy(dtype=float)
                # one group of rows per stored expert, in coordinate order
                starts = np.flatnonzero(np.r_[True, (keys[1:] != keys[:-1]).any(axis=1)])
                groups = np.split(vals, starts[1:])
                row_of = {tuple(k): j for j, k in enumerate(keys[starts].tolist())}
                shape = np.shape(init_cparams[pname])
                got = np.full((E,) + shape, np.nan)
                tree = None
                if lp.get("nearest", False) and len(groups):
                    from scipy.spatial import cKDTree

                    tree = cKDTree(keys[starts].astype(float))
                for e, loc in enumerate(locs.tolist()):
                    j = row_of.get(tuple(loc))
                    if j is None and tree is not None:
                        j = int(tree.query(np.asarray(loc, dtype=float))[1])
                    if j is None or np.isnan(groups[j]).any():
                        continue  # nan params are not loaded (ref: :670-681)
                    got[e] = groups[j].reshape(shape) if shape else groups[j][0]
                out[pname] = got
        return out

    def load_params(
        self,
        model,
        previous=None,
        previous_params=None,
        file=None,
        param_names=None,
        ref_loc=None,
        index_adjust=None,
        table_suffix: str = "",
        **param_dict,
    ) -> int:
        """Set a model's parameters from a results file at one expert
        location, from previous params, or from explicit values (ref:
        local_experts.py:553-606; the same signature and return contract: 0
        on success, 1 if a file read yields no parameters). ``model`` is any
        object with ``param_names`` and ``set_parameters(**params)``."""
        if file is not None:
            assert isinstance(file, str), f"load_params file is not str: {type(file)}"
            assert os.path.exists(file), f"load_params file does not exist:\n{file}"
            rl = dict(pandas_to_dict(ref_loc))
            for k, v in (index_adjust or {}).items():
                rl[k] = config_func(**v, args=rl[k])
            param_dict = self._read_params_for_loc(
                file=file, model=model, ref_loc=rl, param_names=param_names, table_suffix=table_suffix
            )
            if len(param_dict) == 0:
                return 1
        elif previous is not None:
            param_dict = previous_params or {}
        model.set_parameters(**param_dict)
        return 0

    def _read_params_for_loc(self, file, model, ref_loc, param_names=None, table_suffix=""):
        """One expert location's parameters from a results store, keyed by
        coordinate match (ref: local_experts.py:608-689)."""
        import pandas as pd

        names = param_names if param_names is not None else list(model.param_names)
        out = {}
        with PT.open_store(file) as store:
            for pname in names:
                tbl = f"{pname}{table_suffix}"
                pdf = store.select(tbl).reset_index() if tbl in store else None
                if pdf is None or len(pdf) == 0:
                    continue
                m = np.ones(len(pdf), dtype=bool)
                for k, v in ref_loc.items():
                    if k in pdf.columns:
                        m &= pdf[k].values == v
                g = pdf[m]
                if len(g) == 0:
                    continue
                dim_cols = sorted(c for c in g.columns if c.startswith("_dim_"))
                vals = g.sort_values(dim_cols)[pname].values
                if np.any(pd.isna(vals)):
                    continue  # nan params are not loaded (ref: :670-681)
                out[pname] = vals if len(vals) > 1 else vals[0]
        return out

    # ---- table building ----
    @staticmethod
    def dict_of_array_to_table(x, ref_loc=None, concat: bool = False, table=None, default_dim: int = 1):
        """Dict of arrays -> DataFrame(s) multi-indexed by the reference
        location (ref: local_experts.py:691-747)."""
        import pandas as pd

        from gpsat_tpu_torch.utils.tables import dict_of_array_to_dict_of_dataframe

        assert isinstance(x, dict), f"input expected to be dict, got: {type(x)}"
        if len(x) == 0:
            return x
        if concat:
            assert table is not None, "concat is True but (replacement) table (name) not provided"
        dfs = dict_of_array_to_dict_of_dataframe(x, concat=concat, reset_index=True)
        if ref_loc is not None:
            ref_loc = pandas_to_dict(ref_loc)
            assert isinstance(ref_loc, dict), f"ref_loc expected to be dict (or Series), got: {type(ref_loc)}"
            names = list(ref_loc.keys())
            tup = tuple(ref_loc.values())
            for df in dfs.values():
                if len(names) == 1:
                    df.index = pd.Index([tup[0]] * len(df), name=names[0])
                else:
                    df.index = pd.MultiIndex.from_tuples([tup] * len(df), names=names)
        if not concat:
            return dfs
        return {(table if k == default_dim else f"{table}_{k}"): v for k, v in dfs.items()}

    @staticmethod
    def _expert_index_batch(xprt_locs, eis, coords_col):
        """(Multi)Index rows for many experts at once, one per entry of
        ``eis`` (row positions into ``xprt_locs``), with the level dtypes
        of the expert-location frame."""
        import pandas as pd

        if len(coords_col) == 1:
            c = coords_col[0]
            return pd.Index(xprt_locs[c].to_numpy()[eis], name=c)
        return pd.MultiIndex.from_arrays([xprt_locs[c].to_numpy()[eis] for c in coords_col], names=coords_col)

    def _run_details_rows(self, xprt_locs, eis, coords_col, *, num_obs, run_time, objective, optimised, success,
                          num_iter, stalled, model_name, device_name, config_id):
        """run_details rows for experts ``eis`` (ref schema:
        local_experts.py:499-550)."""
        import pandas as pd

        B = len(eis)
        return pd.DataFrame(
            {
                "_dim_0": np.zeros(B, dtype=int),
                "num_obs": np.asarray(num_obs, dtype=int),
                "run_time": np.asarray(run_time, dtype=float),
                "objective_value": np.asarray(objective, dtype=float),
                "parameters_optimised": np.full(B, bool(optimised)),
                "optimise_success": np.asarray(success, dtype=bool),
                # float column, as the JAX package's: NaN marks host models
                # that hide their iteration count
                "num_iter": np.asarray(num_iter, dtype=float),
                # the exit was the L-BFGS stall guard, not a tolerance
                "stalled": np.asarray(stalled, dtype=bool),
                "model": np.full(B, model_name[:64], dtype=object),
                "device": np.full(B, device_name[:64], dtype=object),
                "config_id": np.full(B, config_id),
            },
            index=self._expert_index_batch(xprt_locs, eis, coords_col),
        )

    def _result_tables(self, res, param_names, xprt_locs, coords_col, table_suffix, optimise, model_name,
                       device_name, config_id, predict) -> dict:
        """One bucket's result tables: preds, run_details and one table per
        stored parameter, built from the stacked result arrays with the JAX
        package's row order, dtypes and index values."""
        import pandas as pd

        store_params = param_names if self.params_to_store is None else self.params_to_store
        store_params = [p for p in store_params if p in res]
        eis = np.asarray(res["expert_index"], dtype=int)
        B = len(eis)
        base_idx = self._expert_index_batch(xprt_locs, eis, coords_col)
        tables = {}

        pm = np.asarray(res["pred_mask"])
        P_i = pm.sum(axis=1).astype(int) if pm.ndim == 2 else np.zeros(B, dtype=int)
        if predict and P_i.sum() > 0:
            # padded [B, Pmax] arrays flatten to concatenated [:P_i] rows
            # (row-major boolean indexing == expert-major row order)
            Pmax = pm.shape[1]
            prefix = np.arange(Pmax)[None, :] < P_i[:, None]
            pc_all = np.concatenate([np.asarray(pc)[:p] for pc, p in zip(res["pred_coords"], P_i) if p > 0])
            data = {
                "_dim_0": np.broadcast_to(np.arange(Pmax), (B, Pmax))[prefix],
                "f*": np.asarray(res["f_mean"])[prefix],
                "f*_var": np.asarray(res["f_var"])[prefix],
                "y_var": np.asarray(res["y_var"])[prefix],
                "f_bar": np.repeat(np.asarray(res["obs_mean"]), P_i),
            }
            for ci, c in enumerate(coords_col):
                data[f"pred_loc_{c}"] = pc_all[:, ci]
            pdf = pd.DataFrame(data)
            pdf.index = base_idx.repeat(P_i)
            tables[f"preds{table_suffix}"] = pdf

        tables[f"run_details{table_suffix}"] = self._run_details_rows(
            xprt_locs, eis, coords_col, num_obs=res["num_obs"], run_time=np.full(B, res["batch_s"] / max(B, 1)),
            objective=res["objective"], optimised=optimise, success=res["converged"], num_iter=res["num_iter"],
            stalled=res.get("stalled", np.zeros(B, dtype=bool)), model_name=model_name, device_name=device_name,
            config_id=config_id,
        )

        for pname in store_params:
            arr = np.asarray(res[pname])
            if arr.ndim == 1:
                arr = arr[:, None]  # scalars store as one _dim_0=0 row
            shape = arr.shape[1:]
            size = int(np.prod(shape))
            # n-d params flatten with one _dim_k column per axis
            # (ref: utils.py:1437-1496 array_to_dataframe)
            dims = np.indices(shape).reshape(len(shape), -1)
            data = {f"_dim_{k}": np.tile(dims[k], B) for k in range(len(shape))}
            data[pname] = arr.reshape(B, -1).ravel()
            pdf = pd.DataFrame(data)
            pdf.index = base_idx.repeat(size)
            tables[f"{pname}{table_suffix}"] = pdf
        return tables

    def plot_locations_and_obs(self, image_file: Optional[str] = None, obs_col: Optional[str] = None,
                               max_plots: int = 25, xy_col=("x", "y"), s_obs: float = 2.0):
        """Review plot: expert locations over the observations they select
        (ref: local_experts.py:1282-1463). One panel per expert (up to
        ``max_plots``), coloured by the local observations that
        ``data/select.local_data_select`` gives it. Returns the figure and
        writes it to ``image_file`` when given."""
        import matplotlib.pyplot as plt

        assert self.expert_locs is not None, "expert locations not set"
        obs_col = obs_col or self.data.obs_col
        df = self.data.load(reset_index=True)
        n = min(len(self.expert_locs), max_plots)
        ncols = min(5, n)
        nrows = -(-n // ncols)
        fig, axs = plt.subplots(nrows, ncols, figsize=(3.2 * ncols, 3 * nrows), squeeze=False)
        for i in range(n):
            ax = axs[i // ncols][i % ncols]
            rl = self.expert_locs.iloc[[i]]
            df_loc = sel.local_data_select(df, rl, self.data.local_select or [])
            if len(df_loc):
                ax.scatter(df_loc[xy_col[0]], df_loc[xy_col[1]], c=df_loc[obs_col], s=s_obs, cmap="RdBu_r")
            ax.scatter(rl[xy_col[0]], rl[xy_col[1]], marker="x", color="k", s=60)
            ax.set_title(f"expert {i}: n={len(df_loc)}", fontsize=9)
            ax.set_aspect("equal")
        fig.tight_layout()
        if image_file:
            fig.savefig(image_file, dpi=110)
        return fig


# --------------------------------------------------------------------------
# results reading (ref: local_experts.py:1467-1620)
# --------------------------------------------------------------------------


def get_results_from_h5file(
    results_file: str,
    global_col_funcs=None,
    merge_on_expert_locations: bool = True,
    select_tables=None,
    table_suffix: str = "",
    add_suffix_to_table: bool = True,
    verbose: bool = False,
):
    """Read all (or selected) result tables plus the stored configs.

    Accepts the port's TableStore files and reference-produced
    pandas-HDFStore (PyTables) results files (``data/pytables_compat``).

    Returns (dict of DataFrames, list of configs).
    """
    if PT.is_pytables_store(results_file):
        return _get_results_from_pytables(
            results_file, global_col_funcs, merge_on_expert_locations, select_tables, table_suffix,
            add_suffix_to_table,
        )
    out = {}
    configs = []
    with TableStore(results_file, mode="r") as store:
        keys = store.keys()
        if select_tables is not None:
            want = [f"{t}{table_suffix}" if add_suffix_to_table else t for t in select_tables]
            # configs are always read: readers need coords_col
            keys = [k for k in keys if k in want or k == f"oi_config{table_suffix}"]
        elif table_suffix:
            keys = [k for k in keys if k.endswith(table_suffix)]
        for k in keys:
            if k.startswith("oi_config"):
                cfg_df = store.select(k, set_index=False)
                configs.extend(json.loads(c) for c in cfg_df["config"])
                continue
            out[k] = store.select(k).reset_index()

        if global_col_funcs is not None:
            for k in out:
                DL.add_cols(out[k], global_col_funcs)

        # merge expert-location metadata onto each table
        el_key = f"expert_locs{table_suffix}"
        if merge_on_expert_locations and el_key in store.keys():
            el = store.select(el_key).reset_index()
            for k in list(out.keys()):
                if k.startswith("expert_locs"):
                    continue
                join_cols = [c for c in el.columns if c in out[k].columns]
                if join_cols:
                    extra = [c for c in el.columns if c not in join_cols]
                    if extra:
                        out[k] = out[k].merge(el, on=join_cols, how="left")
    return out, configs


def _get_results_from_pytables(
    results_file, global_col_funcs, merge_on_expert_locations, select_tables, table_suffix, add_suffix_to_table
):
    """``get_results_from_h5file`` over a reference-produced PyTables store
    (``gpsat_tpu/experts.py::_get_results_from_pytables``)."""
    keys = PT.list_tables(results_file)
    if select_tables is not None:
        want = [f"{t}{table_suffix}" if add_suffix_to_table else t for t in select_tables]
        keys = [k for k in keys if k in want or k.startswith("oi_config")]
    elif table_suffix:
        keys = [k for k in keys if k.endswith(table_suffix) or k.startswith("oi_config")]

    out, configs = {}, []
    for k in keys:
        df = PT.read_table(results_file, k)
        if k.startswith("oi_config"):
            configs.extend(json.loads(c) for c in df["config"])
            continue
        drop = all(n is None for n in df.index.names)
        out[k] = df.reset_index(drop=drop)

    if global_col_funcs is not None:
        for k in out:
            DL.add_cols(out[k], global_col_funcs)

    el_key = f"expert_locs{table_suffix}"
    if merge_on_expert_locations and el_key in PT.list_tables(results_file):
        el = PT.read_table(results_file, el_key).reset_index()
        for k in list(out.keys()):
            if k.startswith("expert_locs"):
                continue
            join_cols = [c for c in el.columns if c in out[k].columns]
            if join_cols and [c for c in el.columns if c not in join_cols]:
                out[k] = out[k].merge(el, on=join_cols, how="left")
    return out, configs
