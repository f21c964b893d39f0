"""Model registry (ref: GPSat/models/__init__.py:3-28).

``get_model`` resolves every name of the JAX package's registry, the
reference's names among them, to the port's classes:

- five classes that also run as batched lanes (``GPRModel``, ``SGPRModel``,
  ``SVGPModel``, ``VFFModel``, ``ASVGPModel``, each beside its functional
  core in ``gpr.py``, ``sgpr.py``, ``svgp.py``, ``vff.py``, ``asvgp.py``).
  The orchestrator runs them through their batched cores; built as objects,
  they fit and predict one expert at B = 1 on ``device`` in ``dtype``;
- the host models of the host-serial lane, which the orchestrator builds
  once per expert: ``PureNumpyGPR`` (numpy and scipy), ``SklearnGPRModel``
  (sklearn, imported when one is built) and ``TorchGPRModel`` /
  ``TorchKISSGPModel`` (torch on ``device``).

``param_names`` of a batched-lane class read on the class is the lane's
stored names (``base.lane_param_names``); ``stored_param_names`` gives
them for any class, a host model's from an instance built on the CPU.
"""

import importlib

from gpsat_tpu_torch.models.asvgp import ASVGPModel
from gpsat_tpu_torch.models.base import BaseGPRModel
from gpsat_tpu_torch.models.gpr import GPRModel
from gpsat_tpu_torch.models.sgpr import SGPRModel
from gpsat_tpu_torch.models.svgp import SVGPModel
from gpsat_tpu_torch.models.vff import VFFModel

# name -> (module under gpsat_tpu_torch.models, class); the host models are
# imported when first asked for
_REGISTRY = {
    # native names
    "GPRModel": ("gpr", "GPRModel"),
    "SGPRModel": ("sgpr", "SGPRModel"),
    "SVGPModel": ("svgp", "SVGPModel"),
    "VFFModel": ("vff", "VFFModel"),
    "SklearnGPRModel": ("sklearn_model", "SklearnGPRModel"),
    "ASVGPModel": ("asvgp", "ASVGPModel"),
    "TorchGPRModel": ("torch_gpr", "TorchGPRModel"),
    "TorchKISSGPModel": ("torch_gpr", "TorchKISSGPModel"),
    "PureNumpyGPR": ("pure_numpy_gpr", "PureNumpyGPR"),
    # the reference's names (GPSat/models/__init__.py:3-28)
    "GPflowGPRModel": ("gpr", "GPRModel"),
    "GPflowSGPRModel": ("sgpr", "SGPRModel"),
    "GPflowSVGPModel": ("svgp", "SVGPModel"),
    "GPflowVFFModel": ("vff", "VFFModel"),
    "sklearnGPRModel": ("sklearn_model", "SklearnGPRModel"),
    "GPflowASVGPModel": ("asvgp", "ASVGPModel"),
    "GPyTorchGPRModel": ("torch_gpr", "TorchGPRModel"),
    "GPyTorchKISSGPModel": ("torch_gpr", "TorchKISSGPModel"),
    "PurePythonGPR": ("pure_numpy_gpr", "PureNumpyGPR"),
}


def _resolve(name: str):
    module, attr = _REGISTRY[name]
    return getattr(importlib.import_module(f"gpsat_tpu_torch.models.{module}"), attr)


def get_model(name: str):
    """Resolve a model class by name, accepting the reference's names."""
    assert name in _REGISTRY, f"model: {name} not in registry: {sorted(_REGISTRY)}"
    return _resolve(name)


def filter_kwargs(fn, kwargs: dict) -> dict:
    """``kwargs`` without the keys ``fn`` does not take (all of them if it
    takes ``**kwargs``): host models range from full BaseGPRModel signatures
    to the reference's bare PurePythonGPR(coords, obs, ...)."""
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return dict(kwargs)
    params = sig.parameters.values()
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params):
        return dict(kwargs)
    names = {p.name for p in params}
    return {k: v for k, v in kwargs.items() if k in names}


def placement_kwargs(model_cls, device, dtype) -> dict:
    """``device`` and ``dtype`` (those not None) for a model class whose
    constructor names them (never through ``**kwargs``, which may pass them
    on to a callee that does not take them)."""
    import inspect

    try:
        names = inspect.signature(model_cls).parameters
    except (TypeError, ValueError):
        return {}
    return {k: v for k, v in (("device", device), ("dtype", dtype)) if k in names and v is not None}


def probe_model(model_cls, n_dims: int, kwargs=None, device="cpu", dtype=None):
    """A throwaway instance of ``model_cls`` on 4 points of dummy data (the
    reference's BaseGPRModel contract, ref: base_model.py:270-277), built
    with the ``kwargs`` it takes, on ``device``."""
    import numpy as np

    kw = {"verbose": False, **(kwargs or {})}
    return model_cls(coords=np.linspace(0.0, 1.0, 4)[:, None] * np.ones(n_dims)[None, :], obs=np.zeros(4),
                     **filter_kwargs(model_cls, kw), **placement_kwargs(model_cls, device, dtype))


def stored_param_names(model_cls) -> list:
    """The parameter names a model class's results store: its batched
    lane's for the five lane classes, else those of an instance built on
    the CPU (the JAX package reads them off a pseudo-model)."""
    names = getattr(model_cls, "param_names", None)
    if isinstance(names, (tuple, list)):
        return list(names)
    return list(probe_model(model_cls, 1).param_names)


# every registry name as a module attribute, as ``from GPSat.models.gpflow_models
# import GPflowGPRModel`` reads the reference's (gpsat_tpu/models/__init__.py:
# 56-84), resolved on first use so that importing the package stays light
def __getattr__(name):
    if name not in _REGISTRY:
        raise AttributeError(f"module 'gpsat_tpu_torch.models' has no attribute {name!r}")
    return _resolve(name)


__all__ = ["BaseGPRModel", "get_model", "stored_param_names", *_REGISTRY]
