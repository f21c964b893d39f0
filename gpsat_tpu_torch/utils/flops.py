"""Analytic FLOP counts for the exact-GPR main path and the SGPR, SVGP, VFF and ASVGP lanes.

Port of the GPR, SGPR and SVGP counts of ``gpsat_tpu/utils/flops.py``. The
SVGP core's collapsed solver optimises the SGPR bound and is counted with
the SGPR counts. The VFF and ASVGP counts (which the JAX package does not
have) are derived from ``models/vff.collapsed_terms``.
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


def collapsed_kron_elbo_flops(N: int, Mtot: int) -> float:
    """One forward evaluation of the collapsed bound on a Kronecker feature
    space of Mtot features (``models/vff.collapsed_terms``), model flops
    (Mtot, not its padded width):

      Kuf Kfu                 2 N Mtot^2
      Kuf y                   2 N Mtot
      factor pair of P        Mtot^3 / 3 + Mtot^3 / 3
      c = W (Kuf y)           Mtot^2       (triangular)
      Kuu^-1 o Kuf Kfu        Mtot^2

    The per-dimension features, Grams and inverses are O(D (N m + m^3))
    with m = Mtot^(1/D), and left out."""
    return 2.0 * N * Mtot**2 + 2.0 * N * Mtot + (2.0 / 3.0) * Mtot**3 + 2.0 * Mtot**2


def vff_elbo_flops(N: int, M: int, D: int) -> float:
    """One VFF bound: (2M - 1)^D Fourier features."""
    return collapsed_kron_elbo_flops(N, (2 * M - 1) ** D)


def vff_iter_flops(N: int, M: int, D: int, ad_factor: float = 3.0) -> float:
    """One single-eval L-BFGS iteration of the VFF bound: the bound and its
    reverse-mode gradient (ad_factor 3 counts both)."""
    return ad_factor * vff_elbo_flops(N, M, D)


# B-spline features per knot grid of M knots, beyond M (models/asvgp.py)
_ASVGP_EXTRA = {"Matern12": 0, "Matern32": 1, "Matern52": 2}


def asvgp_elbo_flops(N: int, M: int, D: int, kernel: str = "Matern12") -> float:
    """One ASVGP bound: (M + 0, 1 or 2)^D spline features (B1, B2, B3)."""
    return collapsed_kron_elbo_flops(N, (M + _ASVGP_EXTRA[kernel]) ** D)


def asvgp_iter_flops(N: int, M: int, D: int, kernel: str = "Matern12", ad_factor: float = 3.0) -> float:
    """One single-eval L-BFGS iteration of the ASVGP bound and its gradient."""
    return ad_factor * asvgp_elbo_flops(N, M, D, kernel)
