"""Variational Fourier Features (Hensman, Durrande & Solin 2017), batched
over B, and the host-facing single-expert model.

Port of ``gpsat_tpu/models/vff.py``: ``make_kuu_dense``, ``make_kuf``,
``make_kvs``, ``kron``, ``vff_common``, ``elbo``, ``predict`` (with
``full_cov``), ``product_prior_gram``, ``make_vff_core`` and ``VFFModel``
(the bound at B = 1). Data is
``{"X": [B, N, D], "y": [B, N], "mask": [B, N]}``; params are dicts of
[B, ...] tensors, the per-tile cuboidal domain [B, D, 2] among them.

Per-dimension 1-D Matern kernels on a domain [a, b]^D; the inducing
*features* are Fourier basis functions with closed-form spectral Kuu
(dense, cos block then sin block, 2M - 1 features per dimension) and Kuf
with Matern12/32's outside-domain edge corrections (Matern52 has none:
the core grows its domain to cover the prediction points). Across
dimensions the features form a Kronecker product (Mtot = (2M - 1)^D).

The collapsed bound and posterior (the reference's GPR_kron) share
``collapsed_terms`` with the ASVGP core (``models/asvgp.py``):

  P = Kuf Kfu / s2 + Kuu;  c = L_P^-1 (Kuf y) / s2
  elbo = -n/2 log(2 pi s2) - 1/2 log|P| + 1/2 log|Kuu| - y^T y / (2 s2)
         + |c|^2 / 2 - n kv / (2 s2) + sum(Kuu^-1 o Kuf Kfu) / (2 s2)

P's factor pair comes from ``ops/linalg.chol_winv_padded`` on the route
``factor`` names (kernel 1 on the "block" route in f32 on the card, P
identity-padded to a multiple of 64; its plain version on the CPU), in
every dtype, with gradients through the pair's analytic pullback. The JAX
package's f32 default takes ``cholesky`` + ``tri_inv_blocked`` there and
its f64 ``cholesky`` + ``tri_solve``: the same function, equal at f64
roundoff. The per-dimension Kuu inverses and log-determinants are small
``torch.linalg`` calls, as in the JAX package.

Every tensor is built in the parameters' dtype: an f32 tile stays f32.
"""

from __future__ import annotations

import math
from functools import reduce
from typing import Dict, List, Optional

import numpy as np
import torch

from gpsat_tpu_torch.models import means as MF
from gpsat_tpu_torch.models.base import TorchCoreModel, lane_param_names
from gpsat_tpu_torch.ops import kernels as K
from gpsat_tpu_torch.ops import linalg as LA
from gpsat_tpu_torch.ops import transforms as T

PARAM_NAMES = ["lengthscales", "kernel_variance", "likelihood_variance"]
SUPPORTED_KERNELS = ("Matern12", "Matern32", "Matern52")


def _omegas(a: torch.Tensor, b: torch.Tensor, M: int) -> torch.Tensor:
    """Frequencies 2 pi m / (b - a) [B, M] of a domain [a, b] ([B] each)."""
    ms = torch.arange(M, dtype=a.dtype, device=a.device)
    return 2.0 * math.pi * ms[None, :] / (b - a)[:, None]


def _outer(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return u[:, :, None] * v[:, None, :]


def make_kuu_dense(kernel: str, lengthscale, variance, a, b, M: int) -> torch.Tensor:
    """Dense Kuu [B, 2M-1, 2M-1] of one dimension (cos block, then sin
    block); lengthscale, variance, a, b: [B]."""
    om = _omegas(a, b, M)
    om_s = om[:, 1:]
    var = variance[:, None]
    width = (b - a)[:, None]
    first = torch.zeros(M, dtype=om.dtype, device=om.device)
    first[0] = 1.0  # the constant feature (omega 0) takes half the weight
    if kernel == "Matern12":
        lamb = (1.0 / lengthscale)[:, None]
        d_cos = width * (lamb**2 + om**2) / lamb / var / (4.0 - 2.0 * first)
        v_cos = torch.ones_like(om) / torch.sqrt(var)
        d_sin = width * (lamb**2 + om_s**2) / lamb / var / 4.0
        cos_block = torch.diag_embed(d_cos) + _outer(v_cos, v_cos)
        sin_block = torch.diag_embed(d_sin)
    elif kernel == "Matern32":
        lamb = (math.sqrt(3.0) / lengthscale)[:, None]
        d_cos = width * (lamb**2 + om**2) ** 2 / lamb**3 / var / (8.0 - 4.0 * first)
        v_cos = torch.ones_like(om) / torch.sqrt(var)
        d_sin = width * (lamb**2 + om_s**2) ** 2 / lamb**3 / var / 8.0
        v_sin = om_s / lamb / torch.sqrt(var)
        cos_block = torch.diag_embed(d_cos) + _outer(v_cos, v_cos)
        sin_block = torch.diag_embed(d_sin) + _outer(v_sin, v_sin)
    elif kernel == "Matern52":
        lamb = (math.sqrt(5.0) / lengthscale)[:, None]
        v1 = (3.0 * (om / lamb) ** 2 - 1.0) / torch.sqrt(8.0 * var)
        v2 = torch.ones_like(om) / torch.sqrt(var)
        d_cos = 3.0 * width / (32.0 - 16.0 * first) / lamb**5 / var * (lamb**2 + om**2) ** 3
        v_sin = math.sqrt(3.0) * om_s / lamb / torch.sqrt(var)
        d_sin = 3.0 * width / 32.0 / lamb**5 / var * (lamb**2 + om_s**2) ** 3
        cos_block = torch.diag_embed(d_cos) + _outer(v1, v1) + _outer(v2, v2)
        sin_block = torch.diag_embed(d_sin) + _outer(v_sin, v_sin)
    else:
        raise NotImplementedError(f"VFF supports {SUPPORTED_KERNELS}, got: {kernel}")
    out = om.new_zeros(om.shape[0], 2 * M - 1, 2 * M - 1)
    out[:, :M, :M] = cos_block
    out[:, M:, M:] = sin_block
    return out


def make_kuf(kernel: str, lengthscale, X1d, a, b, M: int) -> torch.Tensor:
    """Kuf [B, 2M-1, N] of one dimension, with the edge corrections outside
    [a, b] for Matern12/32. X1d: [B, N] scaled coordinates; lengthscale,
    a, b: [B]."""
    om = _omegas(a, b, M)[:, :, None]
    om_s = om[:, 1:]
    x = X1d[:, None, :]
    a_, b_, ls = a[:, None, None], b[:, None, None], lengthscale[:, None, None]
    Kuf_cos = torch.cos(om * (x - a_))
    Kuf_sin = torch.sin(om_s * (x - a_))
    lt_a, gt_b = x < a_, x > b_
    if kernel == "Matern12":
        Kuf_sin = torch.where(lt_a | gt_b, torch.zeros_like(Kuf_sin), Kuf_sin)
        Kuf_cos = torch.where(lt_a, torch.exp(-torch.abs(x - a_) / ls), Kuf_cos)
        Kuf_cos = torch.where(gt_b, torch.exp(-torch.abs(x - b_) / ls), Kuf_cos)
    elif kernel == "Matern32":
        arg_a = math.sqrt(3.0) * torch.abs(x - a_) / ls
        arg_b = math.sqrt(3.0) * torch.abs(x - b_) / ls
        Kuf_cos = torch.where(lt_a, (1 + arg_a) * torch.exp(-arg_a), Kuf_cos)
        Kuf_cos = torch.where(gt_b, (1 + arg_b) * torch.exp(-arg_b), Kuf_cos)
        Kuf_sin = torch.where(lt_a, (x - a_) * torch.exp(-arg_a) * om_s, Kuf_sin)
        Kuf_sin = torch.where(gt_b, (x - b_) * torch.exp(-arg_b) * om_s, Kuf_sin)
    elif kernel != "Matern52":
        raise NotImplementedError(f"VFF supports {SUPPORTED_KERNELS}, got: {kernel}")
    # Matern52 has no edge corrections (nor has the reference): outside
    # [a, b] its columns are the periodic extension, so the core grows the
    # domain to cover every point it evaluates
    return torch.cat([Kuf_cos, Kuf_sin], dim=1)


def make_kvs(mats: List[torch.Tensor]) -> torch.Tensor:
    """Column-wise Khatri-Rao product ('kronecker-vector stack'):
    [B, Ma, N] x [B, Mb, N] -> [B, Ma*Mb, N], row i*Mb + j = A_i * B_j."""

    def two(A, B_):
        return (A[:, :, None, :] * B_[:, None, :, :]).reshape(A.shape[0], -1, A.shape[-1])

    return reduce(two, mats)


def kron(mats: List[torch.Tensor]) -> torch.Tensor:
    """Batched Kronecker product: [B, m, m] x [B, n, n] -> [B, mn, mn]."""

    def two(A, B_):
        m, n = A.shape[-1], B_.shape[-1]
        return torch.einsum("bij,bkl->bikjl", A, B_).reshape(A.shape[0], m * n, m * n)

    return reduce(two, mats)


def per_dim_params(cparams: dict, D: int):
    """Per-dimension 1-D kernel params: lengthscales [B, D] and the joint
    kernel variance shared as kv^(1/D) per dimension [B]."""
    return cparams["lengthscales"].reshape(-1, D), cparams["kernel_variance"] ** (1.0 / D)


def collapsed_terms(cparams: dict, data: dict, Kuf_dims: List[torch.Tensor], Kuu_dims: List[torch.Tensor], *,
                    factor: str = "block") -> dict:
    """The factors the collapsed bound and posterior of a Kronecker feature
    space share: (L, W) of P = Kuf Kfu / s2 + Kuu, c, Kuu^-1 (the Kronecker
    product of the per-dimension inverses), log|Kuu|, Kuf Kfu, and the data
    sums. Kuf_dims: per-dimension [B, m_d, N]; Kuu_dims: [B, m_d, m_d]."""
    X, y, m = data["X"], data["y"], data["mask"].to(data["X"].dtype)
    # a trainable prior mean: the bound is taken on the centred observations
    if MF.has_mean(cparams):
        y = y - MF.mean_value(cparams, X)
    s2 = cparams["likelihood_variance"]
    Kuf = make_kvs(Kuf_dims) * m[:, None, :]
    ym = y * m
    KufY = torch.matmul(Kuf, ym[:, :, None])
    KufKfu = torch.matmul(Kuf, Kuf.transpose(1, 2))
    Kuu = kron(Kuu_dims)
    Kuu_inv = kron([torch.linalg.inv(Kd) for Kd in Kuu_dims])
    Mtot = Kuu.shape[-1]
    Kuu_logdet = sum((Mtot / Kd.shape[-1]) * torch.linalg.slogdet(Kd)[1] for Kd in Kuu_dims)
    P = KufKfu / s2[:, None, None] + Kuu
    L, WP = LA.chol_winv_padded(P, factor=factor)
    c = torch.matmul(WP, KufY) / s2[:, None, None]
    return dict(L=L, WP=WP, c=c, Kuu_inv=Kuu_inv, Kuu_logdet=Kuu_logdet, KufKfu=KufKfu, ymsq=torch.sum(ym * ym, -1),
                n=m.sum(-1), s2=s2)


def collapsed_elbo(t: dict, kv: torch.Tensor) -> torch.Tensor:
    """The collapsed bound [B] from ``collapsed_terms``; kv [B] the joint
    kernel variance (the prior's diagonal)."""
    n, s2 = t["n"], t["s2"]
    log_det_P = 2.0 * torch.sum(torch.log(torch.diagonal(t["L"], dim1=-2, dim2=-1)), dim=-1)
    out = -0.5 * n * torch.log(2.0 * math.pi * s2)
    out = out - 0.5 * log_det_P + 0.5 * t["Kuu_logdet"]
    out = out - 0.5 * t["ymsq"] / s2
    out = out + 0.5 * torch.sum(t["c"] ** 2, dim=(1, 2))
    out = out - 0.5 * n * kv / s2
    return out + 0.5 * torch.sum(t["Kuu_inv"] * t["KufKfu"], dim=(1, 2)) / s2


def collapsed_predict(cparams: dict, t: dict, Kus: torch.Tensor, Xnew: torch.Tensor, kernel: str,
                      full_cov: bool) -> dict:
    """Posterior mean and variance at Xnew [B, P, D] from ``collapsed_terms``
    and the features at Xnew, Kus [B, Mtot, P]; ``f_cov`` [B, P, P] with
    ``full_cov`` (the separable product prior)."""
    kv = cparams["kernel_variance"]
    tmp = torch.matmul(t["WP"], Kus)
    f_mean = MF.add_mean(cparams, Xnew, torch.matmul(tmp.transpose(1, 2), t["c"])[:, :, 0])
    KiKus = torch.matmul(t["Kuu_inv"], Kus)
    f_var = kv[:, None] + torch.sum(tmp * tmp, dim=1) - torch.sum(KiKus * Kus, dim=1)
    out = {"f_mean": f_mean, "f_var": f_var, "y_var": f_var + t["s2"][:, None]}
    if full_cov:
        ls, _ = per_dim_params(cparams, Xnew.shape[-1])
        Kss = product_prior_gram(kernel, Xnew, Xnew, ls, kv)
        out["f_cov"] = Kss + torch.matmul(tmp.transpose(1, 2), tmp) - torch.matmul(Kus.transpose(1, 2), KiKus)
    return out


def vff_common(cparams: dict, data: dict, *, kernel: str, a, b, M: int, factor: str = "block") -> dict:
    """``collapsed_terms`` of the Fourier features on domains [a, b] ([B, D]
    each)."""
    D = data["X"].shape[-1]
    ls, var_d = per_dim_params(cparams, D)
    Kuf_dims = [make_kuf(kernel, ls[:, i], data["X"][:, :, i], a[:, i], b[:, i], M) for i in range(D)]
    Kuu_dims = [make_kuu_dense(kernel, ls[:, i], var_d, a[:, i], b[:, i], M) for i in range(D)]
    return collapsed_terms(cparams, data, Kuf_dims, Kuu_dims, factor=factor)


def elbo(cparams: dict, data: dict, *, kernel: str, a, b, M: int, factor: str = "block") -> torch.Tensor:
    """The collapsed VFF bound [B] of padded tiles."""
    t = vff_common(cparams, data, kernel=kernel, a=a, b=b, M=M, factor=factor)
    return collapsed_elbo(t, cparams["kernel_variance"])


def product_prior_gram(kernel: str, X1: torch.Tensor, X2: torch.Tensor, ls: torch.Tensor, kv: torch.Tensor):
    """Separable product-kernel prior Gram [B, P1, P2]: kv * prod_d
    k1d(x_d, x'_d; l_d). VFF's (and ASVGP's) prior is the product of 1-D
    Materns per dimension, not the ARD Matern over the joint radius."""
    one = torch.ones_like(kv)
    G = kv[:, None, None] * torch.ones(X1.shape[0], X1.shape[1], X2.shape[1], dtype=X1.dtype, device=X1.device)
    for d in range(X1.shape[-1]):
        G = G * K.gram(kernel, X1[..., d : d + 1], X2[..., d : d + 1], ls[:, d : d + 1], one)
    return G


def predict(cparams: dict, data: dict, Xnew: torch.Tensor, *, kernel: str, a, b, M: int, full_cov: bool = False,
            factor: str = "block") -> dict:
    """VFF posterior at Xnew [B, P, D]: f_mean, f_var, y_var [B, P], and
    f_cov [B, P, P] with ``full_cov``."""
    t = vff_common(cparams, data, kernel=kernel, a=a, b=b, M=M, factor=factor)
    D = Xnew.shape[-1]
    ls, _ = per_dim_params(cparams, D)
    Kus = make_kvs([make_kuf(kernel, ls[:, i], Xnew[:, :, i], a[:, i], b[:, i], M) for i in range(D)])
    return collapsed_predict(cparams, t, Kus, Xnew, kernel, full_cov)


def keep_or_fill(init: dict, name: str, fill) -> dict:
    """``init`` with the per-tile fixed parameter ``name`` [B, ...]: the
    per-expert values ``init`` already holds (loaded, or carried from an
    earlier fit) are kept, and ``fill()`` computes the rest (all of them,
    or the rows holding a NaN, whose load found nothing)."""
    cur = init.get(name)
    out = dict(init)
    computed = fill()
    if cur is not None and np.ndim(cur) == computed.ndim:
        cur = np.asarray(cur, dtype=float)
        missing = np.isnan(cur.reshape(len(cur), -1)).any(axis=1)
        out[name] = np.where(missing.reshape((-1,) + (1,) * (computed.ndim - 1)), computed, cur)
    else:
        out[name] = computed
    return out


def masked_range(X: np.ndarray, mask: np.ndarray):
    """Per-tile min and max [B, D] of the rows where mask > 0 (inf where a
    tile has none)."""
    m = np.asarray(mask)[..., None] > 0
    return np.where(m, X, np.inf).min(axis=1), np.where(m, X, -np.inf).max(axis=1)


def make_vff_core(
    kernel: str = "Matern32",
    bijectors: Optional[dict] = None,
    num_inducing_features: int = 10,
    domain_size=None,
    margin: float = 1e-3,
    mean_function: Optional[str] = None,
    factor: str = "block",
):
    """VFF core for the batched engine (objective = the negative bound).

    The per-tile domain [B, D, 2] is a fixed parameter with the identity
    bijector. ``prepare_batch_init`` lays it over each tile's masked
    coordinate range +- ``margin`` (Matern52: the live prediction points
    too), grown to ``domain_size`` (in the tile's scaled units) per side
    around the tile's expert location when given (the data midpoint when
    the batch carries none); per-expert domains already in the init
    (loaded, or the fit's own in the polish) are kept. ``factor`` names the
    route of P's factor pair (ops/linalg.PAIR_ROUTES)."""
    from gpsat_tpu_torch.models.functional import ModelCore

    if kernel not in SUPPORTED_KERNELS:
        raise ValueError(f"VFF kernel must be one of {SUPPORTED_KERNELS}, got {kernel!r}")
    if factor not in LA.PAIR_ROUTES:
        raise ValueError(f"factor must be one of {LA.PAIR_ROUTES}, got {factor!r}")
    MF.validate(mean_function)
    mean_names = MF.mean_param_names(mean_function)
    M = int(num_inducing_features)
    bij = {name: T.POSITIVE for name in PARAM_NAMES}
    if bijectors:
        bij.update(bijectors)
    bij["domain"] = T.IDENTITY
    for p in mean_names:
        bij.setdefault(p, T.IDENTITY)

    def forward(uparams):
        return {k: bij[k].forward(v) for k, v in uparams.items()}

    def inverse(cparams):
        return {k: bij[k].inverse(torch.as_tensor(v)) for k, v in cparams.items()}

    def objective(uparams, data):
        c = forward(uparams)
        return -elbo(c, data, kernel=kernel, a=c["domain"][..., 0], b=c["domain"][..., 1], M=M, factor=factor)

    def predict_fn(cparams, data, Xnew):
        dom = cparams["domain"]
        return predict(cparams, data, Xnew, kernel=kernel, a=dom[..., 0], b=dom[..., 1], M=M, factor=factor)

    def init_cparams(D: int, dtype=np.float64, overrides: Optional[dict] = None) -> Dict[str, np.ndarray]:
        out = {
            "lengthscales": np.ones(D, dtype=dtype),
            "kernel_variance": np.asarray(1.0, dtype=dtype),
            "likelihood_variance": np.asarray(1.0, dtype=dtype),
            "domain": np.tile(np.asarray([0.0, 1.0], dtype=dtype), (D, 1)),
        }
        out.update(MF.mean_param_defaults(mean_function, D, dtype=dtype))
        for k, v in (overrides or {}).items():
            if k in out and k != "domain":
                out[k] = np.broadcast_to(np.asarray(v, dtype=dtype), np.shape(out[k])).copy()
        return out

    def domains(batch) -> np.ndarray:
        lo, hi = masked_range(np.asarray(batch.X), batch.mask)
        lo, hi = lo - margin, hi + margin
        bad = ~np.isfinite(lo) | ~np.isfinite(hi)  # dead tiles: a harmless unit domain
        lo, hi = np.where(bad, 0.0, lo), np.where(bad, 1.0, hi)
        if kernel == "Matern52":
            plo, phi = masked_range(np.asarray(batch.Xnew), batch.pred_mask)
            lo = np.where(np.isfinite(plo), np.minimum(lo, plo - margin), lo)
            hi = np.where(np.isfinite(phi), np.maximum(hi, phi + margin), hi)
        if domain_size is not None:
            ds = np.asarray(domain_size, dtype=float).reshape(-1)
            mid = 0.5 * (lo + hi) if batch.expert_loc is None else np.asarray(batch.expert_loc, dtype=float)
            lo = mid - np.maximum(mid - lo, ds)
            hi = mid + np.maximum(hi - mid, ds)
        return np.stack([lo, hi], axis=-1)

    def prepare_batch_init(batch, init):
        return keep_or_fill(init, "domain", lambda: domains(batch))

    return ModelCore(
        name=f"vff_{kernel}",
        objective=objective,
        predict=predict_fn,
        forward=forward,
        inverse=inverse,
        init_cparams=init_cparams,
        param_names=("lengthscales", "kernel_variance", "likelihood_variance", "domain") + mean_names,
        default_fixed_params=("domain",),
        prepare_batch_init=prepare_batch_init,
        num_features=lambda D: (2 * M - 1) ** D,
    )


class VFFModel(TorchCoreModel):
    """VFF on one expert (the reference's GPflowVFFModel contract;
    gpsat_tpu/models/vff.py::VFFModel): ``num_inducing_features`` M per
    dimension on a cuboidal domain [a, b]^D. Without ``domain_size`` the
    domain is the data's range (+- 1e-8); with it, ``expert_loc`` (raw
    units; default the data's mean) +- ``domain_size`` (raw units), divided
    by ``coords_scale`` and grown to contain the data (ref:
    vff_model.py:178-211). The objective is the collapsed bound; P's factor
    pair goes through kernel 1 in f32 on the card."""

    PARAM_NAMES = tuple(PARAM_NAMES)
    param_names = lane_param_names((*PARAM_NAMES, "domain"))

    def __init__(
        self,
        data=None,
        coords_col=None,
        obs_col=None,
        coords=None,
        obs=None,
        coords_scale=None,
        obs_scale=None,
        obs_mean=None,
        verbose: bool = False,
        *,
        kernel: str = "Matern32",
        num_inducing_features=None,
        kernel_kwargs: Optional[dict] = None,
        domain_size=None,
        expert_loc=None,
        noise_variance: Optional[float] = None,
        device=None,
        dtype=torch.float64,
        **kwargs,
    ):
        self._init_device(device, dtype)
        mean_function = MF.validate(kwargs.pop("mean_function", None))
        super().__init__(
            data=data,
            coords_col=coords_col,
            obs_col=obs_col,
            coords=coords,
            obs=obs,
            coords_scale=coords_scale,
            obs_scale=obs_scale,
            obs_mean=obs_mean,
            verbose=verbose,
        )
        assert kernel in SUPPORTED_KERNELS, f"VFF kernel must be one of {SUPPORTED_KERNELS}"
        assert num_inducing_features is not None, "num_inducing_features must be specified"
        self.kernel = kernel
        D = self.coords.shape[1]
        if isinstance(num_inducing_features, list):
            assert len(set(num_inducing_features)) == 1, "this build uses a shared per-dimension feature count"
            num_inducing_features = num_inducing_features[0]
        self.M = int(num_inducing_features)

        lo, hi = self.coords.min(axis=0), self.coords.max(axis=0)
        if domain_size is None:
            a, b = lo - 1e-8, hi + 1e-8
        else:
            ds = np.asarray(domain_size, dtype=float).reshape(-1)
            assert len(ds) in (1, D), "domain_size length must match coordinate dimensions"
            ds = np.broadcast_to(ds, (D,))
            cscale = np.broadcast_to(self.coords_scale, (1, D))[0]
            loc = np.mean(self.coords, axis=0) * cscale if expert_loc is None else expert_loc
            loc = np.asarray(loc, dtype=float).reshape(-1)
            a, b = (loc - ds) / cscale, (loc + ds) / cscale
            a, b = np.where(a < lo, a, lo - 1e-8), np.where(b > hi, b, hi + 1e-8)
        self.a, self.b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)

        kk = dict(kernel_kwargs or {})
        self._init_gpr_params(kk.get("lengthscales", np.ones(D)), kk.get("variance", 1.0), noise_variance,
                              mean_function)

    def _domain(self):
        return self._tensor(self.a)[None], self._tensor(self.b)[None]

    def _bound(self, cparams: dict, data: dict) -> torch.Tensor:
        a, b = self._domain()
        return elbo(cparams, data, kernel=self.kernel, a=a, b=b, M=self.M)

    def get_objective_function_value(self) -> float:
        """The collapsed bound (the reference's VFF reports the ELBO)."""
        with torch.no_grad():
            return float(self._bound(self._cparams(), self._data_dict())[0])

    def optimise_parameters(self, max_iter: int = 10_000, fixed_params=None, **opt_kwargs) -> bool:
        data = self._data_dict()
        return self._minimize(lambda c: -self._bound(c, data), list(fixed_params or []), max_iter, **opt_kwargs)

    def predict(self, coords, full_cov: bool = False, apply_scale: bool = True) -> Dict[str, np.ndarray]:
        Xnew = self._prediction_coords(coords, apply_scale)
        if self.kernel == "Matern52" and (np.any(Xnew < self.a) or np.any(Xnew > self.b)):
            # Matern52's Kuf has no outside-domain edge corrections (nor has
            # the reference, vff.py:499-517): refuse the periodic extension
            raise ValueError("VFF Matern52 prediction locations must lie inside the domain "
                             f"[a, b] = [{self.a}, {self.b}]; grow domain_size to cover them")
        a, b = self._domain()
        with torch.no_grad():
            pred = predict(self._cparams(), self._data_dict(), self._tensor(Xnew)[None], kernel=self.kernel, a=a, b=b,
                           M=self.M, full_cov=full_cov)
        return self._prediction_out(pred, full_cov)
