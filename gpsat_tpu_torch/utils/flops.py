"""Analytic FLOP counts for the exact-GPR main path, the SGPR and SVGP lanes.

Port of the GPR, SGPR and SVGP counts of ``gpsat_tpu/utils/flops.py``. The
SVGP core's collapsed solver optimises the SGPR bound and is counted with
the SGPR counts.
Convention: 1 fused multiply-add = 2 FLOPs; Cholesky N^3/3, triangular
inverse N^3/3, dense matmul [n,k]x[k,m] = 2nkm. These are MODEL flops (the
work the math requires), so achieved FLOP/s = model flops / seconds
compares across implementations. They hold for every factor route and for
the profiled-variance objective alike: each does one Cholesky, one full
triangular inverse and one W^T W per evaluation, whichever kernel factors.
"""

from __future__ import annotations


def gpr_fused_iter_flops(N: int, D: int) -> float:
    """One L-BFGS iteration of the fused value+grad masked LML on an
    N-point tile (every single-eval iteration runs forward + analytic
    backward):

      gram distance matmul   2 N^2 D
      Cholesky               N^3 / 3
      blocked tri inverse    N^3 / 3
      Kinv = W^T W           2 N^3      (dense matmul, counted as executed)
      value solve + alpha    ~4 N^2
      backward contractions  (4 + 2D) N^2
    """
    return (2.0 / 3.0 + 2.0) * N**3 + (2.0 * D + 2 * D + 8.0) * N**2


def gpr_predict_flops(N: int, P: int, D: int) -> float:
    """Posterior mean+var at P points given the factorisation: cross gram
    2NPD + the W Ks product (2 N^2 P)."""
    return 2.0 * N * P * D + 2.0 * N**2 * P


def sgpr_elbo_flops(N: int, M: int, D: int) -> float:
    """One forward evaluation of the collapsed Titsias bound (the same
    chunked or not):

      Kuu gram + factor      2 M^2 D + M^3/3
      Kuf gram               2 N M D
      A = L^-1 Kuf           N M^2        (triangular, N right-hand sides)
      A A^T                  2 N M^2
      LB factor + small      M^3/3 + O(M^2)
    """
    return 3.0 * N * M**2 + 2.0 * N * M * D + (2.0 / 3.0) * M**3 + 2.0 * M**2 * D


def sgpr_iter_flops(N: int, M: int, D: int, ad_factor: float = 3.0) -> float:
    """One single-eval L-BFGS iteration: the bound and its reverse-mode
    gradient, ~2x the forward on top of it (ad_factor 3 counts both)."""
    return ad_factor * sgpr_elbo_flops(N, M, D)


def svgp_elbo_flops(N: int, M: int, D: int) -> float:
    """One forward SVGP ELBO on a full tile: Kuu factor M^3/3, Kus gram
    2 N M D, A = L^-1 Kus (N M^2), SA = q_sqrt^T A (2 N M^2), reductions."""
    return 3.0 * N * M**2 + 2.0 * N * M * D + (1.0 / 3.0) * M**3


def svgp_iter_flops(N: int, M: int, D: int, ad_factor: float = 3.0) -> float:
    """One optimiser iteration: the ELBO and its reverse-mode gradient."""
    return ad_factor * svgp_elbo_flops(N, M, D)
