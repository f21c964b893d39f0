"""Model registry (ref: GPSat/models/__init__.py:3-28).

The port runs five lanes as batched functional cores: exact GPR, sparse GPR,
SVGP, VFF and ASVGP (``functional.make_gpr_core``, ``sgpr.make_sgpr_core``,
``svgp.make_svgp_core``, ``vff.make_vff_core``, ``asvgp.make_asvgp_core``).
``get_model`` resolves the reference's names for them, ``"GPRModel"`` and
``"GPflowGPRModel"`` to ``GPRModel``, ``"SGPRModel"`` and
``"GPflowSGPRModel"`` to ``SGPRModel``, ``"SVGPModel"`` and
``"GPflowSVGPModel"`` to ``SVGPModel``, ``"VFFModel"`` and
``"GPflowVFFModel"`` to ``VFFModel``, ``"ASVGPModel"`` and
``"GPflowASVGPModel"`` to ``ASVGPModel``: classes that mark the lane for
the orchestrator. The host-serial lane's names raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from gpsat_tpu_torch.models import asvgp as _asvgp
from gpsat_tpu_torch.models import gpr as _gpr
from gpsat_tpu_torch.models import sgpr as _sgpr
from gpsat_tpu_torch.models import svgp as _svgp
from gpsat_tpu_torch.models import vff as _vff

_HOST = "the host-serial lane, ROADMAP.md Queue 1 item 3"
_UNPORTED = {
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

    param_names = tuple(_gpr.PARAM_NAMES)


class SGPRModel:
    """Sparse GPR through the batched engine (``make_sgpr_core``), marked
    as ``GPRModel`` is; its parameter names are those of an SGPR without a
    mean function, the inducing points included."""

    param_names = tuple(_sgpr.PARAM_NAMES)


class SVGPModel:
    """SVGP through the batched engine (``make_svgp_core``), marked as
    ``GPRModel`` is; its parameter names are those of an SVGP without a mean
    function, the inducing points and the whitened q included. The JAX
    package's host-facing ``SVGPModel`` class is not ported (ROADMAP.md
    Queue 1 item 7)."""

    param_names = tuple(_svgp.PARAM_NAMES)


class VFFModel:
    """Variational Fourier features through the batched engine
    (``make_vff_core``), marked as ``GPRModel`` is; its parameter names are
    those the JAX orchestrator stores for a VFF core without a mean
    function, the per-tile domain included. The JAX package's host-facing
    ``VFFModel`` class is not ported (ROADMAP.md Queue 1 item 7)."""

    param_names = tuple(_vff.PARAM_NAMES) + ("domain",)


class ASVGPModel:
    """B-spline inducing features through the batched engine
    (``make_asvgp_core``), marked as ``GPRModel`` is; its parameter names
    are those the JAX orchestrator stores for an ASVGP core without a mean
    function, the per-tile knot grids included. The JAX package's
    host-facing ``ASVGPModel`` class is not ported (ROADMAP.md Queue 1 item
    7)."""

    param_names = tuple(_asvgp.PARAM_NAMES) + ("knots",)


_PORTED = {"GPRModel": GPRModel, "GPflowGPRModel": GPRModel, "SGPRModel": SGPRModel, "GPflowSGPRModel": SGPRModel,
           "SVGPModel": SVGPModel, "GPflowSVGPModel": SVGPModel, "VFFModel": VFFModel, "GPflowVFFModel": VFFModel,
           "ASVGPModel": ASVGPModel, "GPflowASVGPModel": ASVGPModel}


def get_model(name: str):
    """Resolve a model class by name, accepting the reference's names."""
    if name in _PORTED:
        return _PORTED[name]
    if name in _UNPORTED:
        raise NotImplementedError(f"model {name!r} is not ported yet; see {_UNPORTED[name]}")
    raise AssertionError(f"model: {name} not in registry: {sorted([*_PORTED, *_UNPORTED])}")
