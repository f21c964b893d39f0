"""gpsat_tpu_torch — local-expert optimal interpolation in PyTorch and CUDA.

A port of ``gpsat_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100. Module
paths mirror ``gpsat_tpu`` so each function's counterpart sits at the same
place; ``vmap`` over experts becomes an explicit leading batch dimension B.
The package imports nothing of ``gpsat_tpu`` and never imports ``jax``.

It runs five model lanes, each a batched core fitted by the same engine:
exact GPR (``models/functional.make_gpr_core``), sparse GPR
(``models/sgpr``), SVGP (``models/svgp``), and the collapsed inter-domain
lanes VFF (``models/vff``) and ASVGP (``models/asvgp``). The same five are
host-facing classes too (``models.get_model("GPflowGPRModel")(data=df,
...)``: one expert, fitted and predicted at B = 1), and any other model
class (numpy, sklearn, torch, or a user's) runs on the host-serial lane,
one model object per expert.

Three hand-written CUDA kernels replace the JAX package's Pallas kernels:
the 64x64 diagonal-block Cholesky + inverse (``csrc/block_chol.cu``, bound in
``ops/block_chol.py``), the 128x128 one (``csrc/panel_chol.cu``,
``ops/panel_chol.py``) and the full blocked Cholesky (``csrc/cholesky.cu``,
``ops/cholesky.py``), all built and loaded by ``ops/_build.py``. A fourth,
the batched 3xTF32 product (``csrc/mm3xtf32.cu``, ``ops/mm3xtf32.py``),
stands in for XLA's ``Precision.HIGH`` dot in the SGPR chunk loop at
``accum_precision="high"`` (``ops/precision.py``). A CPU tensor takes the
kernel's plain PyTorch version instead.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

import os as _os

import torch

# GP linear algebra needs true-f32 matmuls: TF32 keeps ~3 decimal digits and
# breaks Cholesky conditioning, the way bf16 passes did on the TPU
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"


def get_path(*sub_dirs: str) -> str:
    """Path under the installed package directory (ref: GPSat/__init__.py:13-15)."""
    return _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), *sub_dirs)


def get_parent_path(*sub_dirs: str) -> str:
    """Path under the repository root (ref: GPSat/__init__.py helper)."""
    parent = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    return _os.path.join(parent, *sub_dirs)


def get_config_path(*sub_dirs: str) -> str:
    """Path under <repo>/configs (ref: GPSat/__init__.py:23-25)."""
    return get_parent_path("configs", *sub_dirs)


def get_data_path(*sub_dirs: str) -> str:
    """Path under <repo>/data (ref: GPSat/__init__.py helper)."""
    return get_parent_path("data", *sub_dirs)
