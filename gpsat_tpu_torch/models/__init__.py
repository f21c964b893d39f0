"""Model registry (ref: GPSat/models/__init__.py:3-28).

The port runs exact GPR as a batched functional core
(``functional.make_gpr_core``). ``get_model`` resolves the reference's names
for it, ``"GPRModel"`` and ``"GPflowGPRModel"``, to ``GPRModel``, which marks
that lane for the orchestrator. Every other name of the JAX package's
registry raises ``NotImplementedError`` naming its ROADMAP.md item.
"""

from gpsat_tpu_torch.models.gpr import PARAM_NAMES

_ZOO = "the model zoo, ROADMAP.md Queue 1 item 7"
_HOST = "the host-serial lane, ROADMAP.md Queue 1 item 3"
_UNPORTED = {
    "SGPRModel": _ZOO,
    "SVGPModel": _ZOO,
    "VFFModel": _ZOO,
    "ASVGPModel": _ZOO,
    "GPflowSGPRModel": _ZOO,
    "GPflowSVGPModel": _ZOO,
    "GPflowVFFModel": _ZOO,
    "GPflowASVGPModel": _ZOO,
    "SklearnGPRModel": _HOST,
    "TorchGPRModel": _HOST,
    "TorchKISSGPModel": _HOST,
    "PureNumpyGPR": _HOST,
    "sklearnGPRModel": _HOST,
    "GPyTorchGPRModel": _HOST,
    "GPyTorchKISSGPModel": _HOST,
    "PurePythonGPR": _HOST,
}


class GPRModel:
    """Exact GPR through the batched engine (``make_gpr_core``). The
    per-expert host model API of the JAX package's ``GPRModel`` is not
    ported; the orchestrator reads this class's name, and the smoothing and
    parameter loading its parameter names (those of a GPR without a mean
    function)."""

    param_names = tuple(PARAM_NAMES)


def get_model(name: str):
    """Resolve a model class by name, accepting the reference's names."""
    if name in ("GPRModel", "GPflowGPRModel"):
        return GPRModel
    if name in _UNPORTED:
        raise NotImplementedError(f"model {name!r} is not ported yet; see {_UNPORTED[name]}")
    raise AssertionError(f"model: {name} not in registry: {sorted(['GPRModel', 'GPflowGPRModel', *_UNPORTED])}")
