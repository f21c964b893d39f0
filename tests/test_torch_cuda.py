"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions. Every test is marked ``cuda`` and skips without a CUDA
device. The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gpsat_tpu_torch.models.functional import make_gpr_core
from gpsat_tpu_torch.ops import block_chol as BC
from gpsat_tpu_torch.ops import cholesky as CH
from gpsat_tpu_torch.ops import linalg as LA
from gpsat_tpu_torch.ops import panel_chol as PC
from gpsat_tpu_torch.ops.linalg import chol_winv_batched
from gpsat_tpu_torch.parallel import engine as TE
from gpsat_tpu_torch.parallel.batching import TileBatch, cast_batch

T = 64


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _spd(B, N, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, N, N)) / np.sqrt(N)
    return (A @ np.swapaxes(A, 1, 2) + np.eye(N)).astype(np.float32)


@pytest.mark.cuda
def test_block_kernel_matches_reference():
    dev = _cuda()
    K = torch.from_numpy(_spd(512, T, seed=0)).to(dev)
    before = BC.factor_blocks.launches
    L, W = BC.factor_blocks(K)
    torch.cuda.synchronize()
    assert BC.factor_blocks.launches == before + 1
    Lr, Wr = BC.factor_blocks_reference(K)
    # f32 on the card, FMA-contracted in the kernel and not in the plain
    # version: 1e-4 absolute on O(1) entries
    assert float((L - Lr).abs().max()) <= 1e-4
    assert float((W - Wr).abs().max()) <= 1e-4
    eye = torch.eye(T, device=dev)
    assert float((torch.matmul(L, W) - eye).abs().max()) <= 1e-4
    assert float(torch.triu(L, 1).abs().max()) == 0.0 and float(torch.triu(W, 1).abs().max()) == 0.0


@pytest.mark.cuda
def test_block_kernel_nan_and_refusals():
    dev = _cuda()
    eye = torch.eye(T, device=dev)
    L, W = BC.factor_blocks(torch.stack([eye, -eye]).contiguous())
    assert torch.isfinite(L[0]).all() and torch.isnan(L[1]).any() and torch.isnan(W[1]).any()
    with pytest.raises(TypeError):
        BC.factor_blocks(eye[None].double())
    with pytest.raises(ValueError):
        BC.factor_blocks(torch.eye(2 * T, device=dev).reshape(4, T, T).transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 133, 512])
def test_block_kernel_batches(B):
    # one matrix, a few, 133 (more blocks than SMs) and the main path's 512,
    # entries like the driver's (A A^T / 64 + I), against the plain version
    # (the TPU kernel's 64-step loop; the kernel runs 2x2 blocks of 32 with
    # an approximate rsqrtf): 1e-4 on L, W and L W - I; then an identity,
    # which must come back exactly, and zero upper triangles
    dev = _cuda()
    K = torch.from_numpy(_spd(B, T, seed=10 + B)).to(dev)
    L, W = BC.factor_blocks(K)
    torch.cuda.synchronize()
    Lr, Wr = BC.factor_blocks_reference(K)
    assert float((L - Lr).abs().max()) <= 1e-4
    assert float((W - Wr).abs().max()) <= 1e-4
    eye = torch.eye(T, device=dev)
    assert float((torch.matmul(L, W) - eye).abs().max()) <= 1e-4
    assert float(torch.triu(L, 1).abs().max()) == 0.0 and float(torch.triu(W, 1).abs().max()) == 0.0
    K[-1] = eye
    L, W = BC.factor_blocks(K)
    assert torch.equal(L[-1], eye) and torch.equal(W[-1], eye)
    assert BC.blocks_per_sm() >= 4  # 512 matrices in one wave on 132 SMs


@pytest.mark.cuda
@pytest.mark.parametrize("factor", ["block", "panel", "cholesky", "recursive"])
def test_f64_tile_batch_on_card_matches_cpu(factor):
    # f64 on the card takes the library arm of the kernel routes (the kernels
    # take f32 only): the whole fit and predict runs on every route and lands
    # where the same f64 run on the CPU does, to the north star's 1e-5
    _cuda()
    Bt, Nt, Pt, Dt = 4, 256, 8, 2
    rng = np.random.default_rng(11)
    X = rng.uniform(-6, 6, (Bt, Nt, Dt))
    y = np.sin(X[..., 0]) * np.cos(X[..., 1]) + 0.1 * rng.normal(size=(Bt, Nt))
    mask = np.ones((Bt, Nt))
    fill = rng.integers(int(0.6 * Nt), Nt + 1, size=Bt)
    for i, f in enumerate(fill):
        mask[i, f:] = 0.0
    batch = TileBatch(X=X, y=y, mask=mask, Xnew=rng.uniform(-4, 4, (Bt, Pt, Dt)), pred_mask=np.ones((Bt, Pt)),
                      obs_mean=np.zeros(Bt), expert_index=np.arange(Bt), num_obs=fill)
    core = make_gpr_core(jitter=1e-5, factor=factor)
    kw = dict(linesearch="single_eval", tol_grad=1e-6, tol_f=1e-11)
    res = {}
    for device in ("cuda", "cpu"):
        runner = TE.make_batched_runner(core, device=device, **kw)
        res[device] = TE.run_tile_batch(batch, {"smart_init": True}, runner, core, device=device)
    for key in ("f_mean", "f_var"):
        assert res["cuda"][key].dtype == np.float64
        assert float(np.abs(res["cuda"][key] - res["cpu"][key]).max()) <= 1e-5, (factor, key)
    assert res["cuda"]["converged"].all() and not res["cuda"]["failed"].any()


@pytest.mark.cuda
def test_driver_on_card_matches_cpu_f64():
    # the whole factor pair, f32 through the kernel vs f64 through the plain
    # version; cond(K) <= ~5 here, so f32 agrees to ~1e-5
    dev = _cuda()
    K = _spd(8, 256, seed=1)
    L, W = chol_winv_batched(torch.from_numpy(K).to(dev))
    L64, W64 = chol_winv_batched(torch.from_numpy(K).double())
    assert float((L.double().cpu() - L64).abs().max()) <= 1e-4
    assert float((W.double().cpu() - W64).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_panel_kernel_matches_reference_and_keeps_the_clamp():
    dev = _cuda()
    TP = PC.T_PANEL
    K = torch.from_numpy(_spd(40, TP, seed=2)).to(dev)
    before = PC.factor_panels.launches
    L, W = PC.factor_panels(K)
    torch.cuda.synchronize()
    assert PC.factor_panels.launches == before + 1
    Lr, Wr = PC.factor_panels_reference(K)
    # f32 on the card, 128 dependent steps, O(1) entries here
    assert float((L - Lr).abs().max()) <= 1e-5
    assert float((W - Wr).abs().max()) <= 1e-5
    eye = torch.eye(TP, device=dev)
    assert float((torch.matmul(L, W) - eye).abs().max()) <= 2e-5
    assert float(torch.triu(L, 1).abs().max()) == 0.0 and float(torch.triu(W, 1).abs().max()) == 0.0
    # the clamp: an all-zero block is finite and equals the plain version's
    odd = torch.stack([torch.zeros_like(eye), eye]).contiguous()
    Lz, Wz = PC.factor_panels(odd)
    Lzr, Wzr = PC.factor_panels_reference(odd)
    assert torch.isfinite(Lz).all() and torch.isfinite(Wz).all()
    assert torch.allclose(Lz, Lzr, rtol=1e-6, atol=0) and torch.allclose(Wz, Wzr, rtol=1e-6, atol=0)
    with pytest.raises(TypeError):
        PC.factor_panels(eye[None].double())
    with pytest.raises(ValueError):
        PC.factor_panels(torch.eye(2 * TP, device=dev).reshape(4, TP, TP).transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 133])
def test_panel_kernel_batches(B):
    # one block, a few, and 133 (more than one wave of two blocks per SM on
    # 132 SMs leaves a ragged last wave); entries like the panel route's
    # (A A^T + 128 I: K up to ~300, L O(10), Linv O(0.1)) at the bounds the
    # card holds the kernel to, then the clamp and identity cases among them
    dev = _cuda()
    TP = PC.T_PANEL
    rng = np.random.default_rng(8)
    A = rng.standard_normal((B, TP, TP)).astype(np.float32)
    K = torch.from_numpy(A @ np.swapaxes(A, 1, 2) + TP * np.eye(TP, dtype=np.float32)).to(dev)
    L, W = PC.factor_panels(K)
    torch.cuda.synchronize()
    Lr, Wr = PC.factor_panels_reference(K)
    assert float((L - Lr).abs().max()) <= 2e-4
    assert float((W - Wr).abs().max()) <= 2e-5
    eye = torch.eye(TP, device=dev)
    assert float((torch.matmul(L, W) - eye).abs().max()) <= 2e-5
    assert float(torch.triu(L, 1).abs().max()) == 0.0 and float(torch.triu(W, 1).abs().max()) == 0.0
    K[B // 2] = 0.0
    K[-1] = eye
    L, W = PC.factor_panels(K)
    Lr, Wr = PC.factor_panels_reference(K)
    assert torch.isfinite(L).all() and torch.isfinite(W).all()
    assert torch.allclose(L[B // 2], Lr[B // 2], rtol=1e-6, atol=0)
    assert torch.allclose(W[B // 2], Wr[B // 2], rtol=1e-6, atol=0)
    assert torch.equal(L[-1], eye) and torch.equal(W[-1], eye)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(3, 128), (5, 384), (2, 1024), (1, 512), (133, 512)])
def test_cholesky_kernel_matches_reference(B, N):
    dev = _cuda()
    K = torch.from_numpy(_spd(B, N, seed=3)).to(dev)
    before = CH.cholesky.launches
    L = CH.cholesky(K)
    torch.cuda.synchronize()
    assert CH.cholesky.launches == before + 1  # one call of the host entry, however many kernels it launches
    # f32 on the card vs the plain version and vs f64 LAPACK; cond(K) <= ~5
    assert float((L - CH.cholesky_reference(K)).abs().max()) <= 1e-5
    L64 = torch.linalg.cholesky(K.double().cpu())
    assert float((L.double().cpu() - L64).abs().max()) <= 1e-5
    assert float(torch.triu(L, 1).abs().max()) == 0.0
    # an unbatched matrix takes the kernel too
    assert torch.equal(CH.cholesky(K[0].contiguous()), L[0])


@pytest.mark.cuda
def test_cholesky_kernel_nan_dispatch_and_refusals():
    dev = _cuda()
    eye = torch.eye(256, device=dev)
    L = CH.cholesky(torch.stack([eye, -eye]).contiguous())
    assert torch.equal(L[0], eye) and torch.isnan(L[1]).any()
    # outside the kernel's domain the library arm runs and counts no launch
    before = CH.cholesky.launches
    L100 = CH.cholesky(torch.from_numpy(_spd(2, 100, seed=4)).to(dev))
    L64 = CH.cholesky(eye[None].double())
    assert CH.cholesky.launches == before
    assert L100.shape == (2, 100, 100) and torch.equal(L64[0], eye.double())
    assert torch.isnan(CH.cholesky(-eye[None, :100, :100].contiguous())).all()
    with pytest.raises(ValueError):
        CH.cholesky(torch.from_numpy(_spd(2, 256, seed=7)).to(dev).transpose(1, 2))
    # the backward runs on the card through the kernel's output
    K = torch.from_numpy(_spd(2, 128, seed=5)).to(dev).requires_grad_(True)
    torch.log(torch.diagonal(CH.cholesky(K), dim1=1, dim2=2)).sum().backward()
    want = 0.5 * torch.linalg.inv(K.detach().double())  # d(0.5 logdet K)/dK
    assert float((K.grad.double() - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_cholesky_kernel_nan_beside_identity_n512():
    # N=512: the diagonal, panel and trailing kernels all run. A -I matrix,
    # one that fails only in its third 128-block, an identity and an SPD
    # matrix in one batch: NaN in the failing two only, the identity exact,
    # the first 256 rows of the late failure exact, the SPD matrix as the
    # plain version has it (1e-5 on O(1) entries, cond(K) <= ~5)
    dev = _cuda()
    N = 512
    eye = torch.eye(N, device=dev)
    late = eye.clone()
    late[300, 300] = -1.0
    spd = torch.from_numpy(_spd(1, N, seed=9)).to(dev)[0]
    L = CH.cholesky(torch.stack([eye, -eye, late, spd]).contiguous())
    torch.cuda.synchronize()
    assert torch.equal(L[0], eye)
    assert torch.isnan(L[1]).any() and torch.isnan(L[2]).any()
    assert torch.equal(L[2, :256], eye[:256])
    assert torch.isfinite(L[3]).all()
    assert float((L[3] - CH.cholesky_reference(spd[None])[0]).abs().max()) <= 1e-5
    assert float(torch.triu(L[3], 1).abs().max()) == 0.0
    blocks = CH.blocks_per_sm()  # the diagonal kernel's design needs two per SM, the trailing kernel's one
    assert blocks["chol_diag_kernel"] >= 2 and blocks["chol_trailing_kernel"] >= 1, blocks


@pytest.mark.cuda
def test_factor_routes_agree_on_card():
    # the four routes' pairs through their kernels, f32, against f64 on the CPU
    dev = _cuda()
    K = _spd(4, 256, seed=6)
    L64, W64 = chol_winv_batched(torch.from_numpy(K).double())
    Kd = torch.from_numpy(K).to(dev)
    for factor in LA.PAIR_ROUTES:
        L, W = LA.chol_winv_pair(Kd, factor)
        assert float((L.double().cpu() - L64).abs().max()) <= 1e-4, factor
        assert float((W.double().cpu() - W64).abs().max()) <= 1e-4, factor
    L, Wdiag = LA.chol_panels_batched(Kd)
    W = LA.tri_inv_from_diag(L, Wdiag)
    assert float((L.double().cpu() - L64).abs().max()) <= 1e-4
    assert float((W.double().cpu() - W64).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_oi_sweep_with_polish_on_card_matches_cpu():
    # the 2x2 expert grid of tests/test_experts_oi.py through the
    # orchestrator's sweep (LocalExpertOI.run's device path; the card's
    # machine has no h5py for the store), f32 + f64 polish on the card and on
    # the CPU: the two f32 fits part by roundoff, each polish ends at the same
    # f64 optimum, within the north star's 1e-5
    dev = _cuda()
    from gpsat_tpu_torch.data.prediction_locations import PredictionLocations
    from gpsat_tpu_torch.experts import sweep

    rng = np.random.default_rng(11)
    n = 500
    x, y = rng.uniform(0, 10, n), rng.uniform(0, 10, n)
    t = rng.integers(0, 3, n).astype(float)
    cols = {"x": x, "y": y, "t": t, "obs": np.sin(x) * np.cos(y) + 0.1 * rng.normal(size=n)}
    experts = {"x": np.array([3.0, 3.0, 7.0, 7.0]), "y": np.array([3.0, 7.0, 3.0, 7.0]), "t": np.ones(4)}

    def run(device):
        pred_loc = PredictionLocations("shift_arrays", coords_col=["x", "y", "t"], x=np.array([-0.5, 0.0, 0.5]),
                                       y=np.array([0.0]))
        before = BC.factor_blocks.launches
        (res,) = sweep(
            cols, experts, coords_col=["x", "y", "t"], obs_col="obs",
            local_select=[{"col": ["x", "y"], "comp": "<", "val": 4.0}, {"col": "t", "comp": "<=", "val": 1.0},
                          {"col": "t", "comp": ">=", "val": -1.0}],
            pred_loc=pred_loc, init_params={"kernel": "Matern32", "noise_variance": 0.01, "jitter": 1e-5},
            constraints={"lengthscales": {"low": 0.1, "high": 20.0}},
            optim_kwargs={"max_iter": 300, "polish": "f64", "polish_max_iter": 150}, device=device,
        )
        return res, BC.factor_blocks.launches - before

    card, launched = run(dev)
    cpu, _ = run("cpu")
    assert launched > 0  # the f32 fit ran kernel 1; the f64 polish runs none
    assert card["f_mean"].dtype == np.float64 and card["converged"].all() and cpu["converged"].all()
    np.testing.assert_array_equal(card["expert_index"], cpu["expert_index"])
    for k in ("f_mean", "f_var"):
        assert float(np.abs(card[k] - cpu[k]).max()) <= 1e-5, k


@pytest.mark.cuda
def test_gaussian_2d_weight_on_card_matches_cpu():
    # the smoothing's weighted mean in f64 on the card against the same call
    # on the CPU: the same sums in another order
    dev = _cuda()
    from gpsat_tpu_torch.postprocess import gaussian_2d_weight

    rng = np.random.default_rng(8)
    x, y = rng.uniform(-4.5e6, 4.5e6, 1664), rng.uniform(-4.5e6, 4.5e6, 1664)
    vals = rng.lognormal(size=1664)
    vals[rng.choice(1664, 100, replace=False)] = np.nan
    card = gaussian_2d_weight(x, y, x, y, 2e5, 2e5, vals, device=dev)
    cpu = gaussian_2d_weight(x, y, x, y, 2e5, 2e5, vals, device="cpu")
    assert card.dtype == np.float64 and np.isfinite(card).all()
    np.testing.assert_allclose(card, cpu, rtol=1e-10, atol=0)


@pytest.mark.cuda
def test_tile_batch_carry_on_card_at_133_lanes():
    # unconverged-lane compaction on the card in f32 on the "block" route:
    # every lane converges, and each lane's iterations are its head's plus,
    # where the tail resumed it, its tail's
    dev = _cuda()
    B, N, P, D = 133, 128, 16, 2
    rng = np.random.default_rng(4)
    X = rng.uniform(-6, 6, (B, N, D)).astype(np.float32)
    y = (np.sin(X[..., 0]) * np.cos(X[..., 1]) + 0.1 * rng.normal(size=(B, N))).astype(np.float32)
    mask = np.ones((B, N), dtype=np.float32)
    for i, f in enumerate(rng.integers(int(0.6 * N), N + 1, size=B)):
        mask[i, f:] = 0.0
    batch = TileBatch(X=X, y=y, mask=mask, Xnew=rng.uniform(-4, 4, (B, P, D)).astype(np.float32),
                      pred_mask=np.ones((B, P), dtype=np.float32), obs_mean=np.zeros(B, dtype=np.float32),
                      expert_index=np.arange(B), num_obs=mask.sum(1).astype(int))
    core = make_gpr_core(jitter=1e-5)
    kw = dict(linesearch="single_eval", return_state=True, device=dev)
    head = TE.make_batched_runner(core, max_iter=5, **kw)
    tail = TE.make_batched_runner(core, max_iter=100, take_state=True, **kw)
    before = BC.factor_blocks.launches
    res = TE.run_tile_batch_carry(batch, {"smart_init": True}, head, tail, core, device=dev)
    assert BC.factor_blocks.launches > before
    info = res["compaction"]
    assert res["converged"].all() and not res["failed"].any()
    assert info["head_width"] == 256 and len(info["tail_rows"]) > 0 and info["tail_width"] >= len(info["tail_rows"])
    want = info["head_num_iter"].copy()
    want[info["tail_rows"]] += info["tail_num_iter"]
    np.testing.assert_array_equal(res["num_iter"], want)
    assert np.isfinite(res["f_mean"]).all() and np.isfinite(res["f_var"]).all()


def _sgpr_batch(B, N, P, dtype, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-6, 6, (B, N, 2)).astype(dtype)
    y = (np.sin(X[..., 0]) * np.cos(X[..., 1]) + 0.1 * rng.normal(size=(B, N))).astype(dtype)
    mask = np.ones((B, N), dtype=dtype)
    for i, f in enumerate(rng.integers(int(0.9 * N), N + 1, size=B)):
        mask[i, f:] = 0.0
    return TileBatch(X=X, y=y, mask=mask, Xnew=rng.uniform(-4, 4, (B, P, 2)).astype(dtype),
                     pred_mask=np.ones((B, P), dtype=dtype), obs_mean=np.zeros(B, dtype=dtype),
                     expert_index=np.arange(B), num_obs=mask.sum(1).astype(int))


@pytest.mark.cuda
def test_sgpr_f32_batch_on_card_matches_cpu_f64_and_launches_kernel_1():
    # the SGPR lane in f32 on the "block" route: kernel 1 factors Kuu and
    # B = A A^T + I (M = 100, identity-padded to 128: two launches per pair)
    # in every evaluation; held against the same fit in f64 on the CPU at the
    # raw-f32 band of chip_smoke.py's phase 4
    from gpsat_tpu_torch.models.sgpr import make_sgpr_core

    dev = _cuda()
    core = make_sgpr_core(num_inducing_points=100)
    batch = _sgpr_batch(8, 512, 16, np.float32)
    before = BC.factor_blocks.launches
    runner = TE.make_batched_runner(core, fixed_params=core.default_fixed_params, max_iter=300, device=dev)
    res = TE.run_tile_batch(batch, {"smart_init": True}, runner, core, device=dev)
    launches = BC.factor_blocks.launches - before
    assert launches == (int(res["num_iter"].max()) + 2) * 4 and launches > 0
    cpu_runner = TE.make_batched_runner(core, fixed_params=core.default_fixed_params, max_iter=1000,
                                        linesearch="single_eval", device="cpu")
    cpu = TE.run_tile_batch(cast_batch(batch, np.float64), {"smart_init": True}, cpu_runner, core, device="cpu")
    assert res["converged"].sum() >= 7 and cpu["converged"].all()
    for key in ("f_mean", "f_var"):
        assert np.isfinite(res[key]).all()
        assert float(np.abs(res[key] - cpu[key]).max()) <= 1e-2, key


@pytest.mark.cuda
def test_chol_winv_padded_gradient_on_the_kernel_matches_the_plain_version():
    # the differentiable pair in the SGPR lane's role: forward on kernel 1,
    # pullback in matmuls, on [B, 100, 100] padded to 128; the plain version
    # runs the same function on the CPU in f64 (cond(K) <= ~5 here)
    dev = _cuda()
    K = torch.from_numpy(_spd(6, 100, seed=9))
    G1, G2 = torch.randn(2, 6, 100, 100, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    grads = {}
    for name, Kx in (("card", K.to(dev)), ("cpu", K.double())):
        Kx = Kx.clone().requires_grad_(True)
        before = BC.factor_blocks.launches
        L, W = LA.chol_winv_padded(Kx)
        ((torch.tril(L) * G1.to(Kx)).sum() + (torch.tril(W) * G2.to(Kx)).sum()).backward()
        grads[name] = Kx.grad.double().cpu()
        assert (BC.factor_blocks.launches - before) == (2 if name == "card" else 0)
    scale = float(grads["cpu"].abs().max())
    assert float((grads["card"] - grads["cpu"]).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["collapsed", "adam_natgrad"])
def test_svgp_f32_batch_on_card_matches_cpu_and_launches_kernel_1(solver):
    # the SVGP lane in f32 on the "block" route (M = 64: one launch per
    # pair): the collapsed bound (two pairs per evaluation, two in the
    # closed-form q, one in the predict) to convergence, and 40 Adam +
    # natural-gradient steps (two evaluations per step); held against the
    # same f32 run on the CPU at the raw-f32 band of chip_smoke.py's phase 4
    from gpsat_tpu_torch.models.svgp import make_svgp_core

    dev = _cuda()
    batch = _sgpr_batch(8, 512, 16, np.float32)
    if solver == "collapsed":
        core = make_svgp_core(num_inducing_points=64)
        kw = dict(max_iter=300)
        expected = lambda it: 2 * (it + 1) + 3  # noqa: E731
    else:
        core = make_svgp_core(num_inducing_points=64, natural_gradients=True, gamma=0.5)
        kw = dict(max_iter=40, learning_rate=1e-2, check_every=10, persistence=100)
        expected = lambda it: 2 * it + 4  # noqa: E731
    out = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        before = BC.factor_blocks.launches
        runner = TE.make_runner_for(core, fixed_params=core.default_fixed_params, device=d, **kw)
        out[name] = TE.run_tile_batch(batch, {"smart_init": True}, runner, core, device=d)
        launches = BC.factor_blocks.launches - before
        want = expected(int(out[name]["num_iter"].max())) if name == "card" else 0
        assert launches == want and (launches > 0) == (name == "card"), (name, launches)
    assert out["card"]["converged"].sum() >= 7 and out["cpu"]["converged"].sum() >= 7
    for key in ("f_mean", "f_var"):
        assert np.isfinite(out["card"][key]).all()
        assert float(np.abs(out["card"][key] - out["cpu"][key]).max()) <= 1e-2, key


@pytest.mark.cuda
@pytest.mark.parametrize("linesearch", ["zoom", "backtracking"])
def test_probing_line_searches_in_f64_on_card_match_cpu(linesearch):
    # the f64 GPR fit with each probing search on the card (the library arm,
    # no kernel) against the same fit on the CPU, held to chip_smoke.py's
    # phase 10 (d) bound (phase f64's 1.2e-8)
    dev = _cuda()
    core = make_gpr_core(jitter=1e-5)
    batch = cast_batch(_sgpr_batch(8, 128, 16, np.float32), np.float64)
    res = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        runner = TE.make_batched_runner(core, max_iter=500, linesearch=linesearch, device=d)
        res[name] = TE.run_tile_batch(batch, {"smart_init": True}, runner, core, device=d)
        assert res[name]["converged"].all()
    for key in ("f_mean", "f_var"):
        assert float(np.abs(res["card"][key] - res["cpu"][key]).max()) <= 1.2e-8, key


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["vff", "asvgp"])
def test_inter_domain_f32_batch_on_card_matches_the_library_route(model):
    # the VFF (Matern32, M = 4: 49 features) and ASVGP (Matern12, 8 knots:
    # 64 features) lanes in f32 on the card: on the "block" route kernel 1
    # factors P (padded to 64: one launch per pair) in every evaluation and
    # in the predict; on the "cholesky" route the same fit takes the library
    # (a 64-wide Gram is outside kernel 3's domain), and the two agree at the
    # raw-f32 band of chip_smoke.py's phase 4
    from gpsat_tpu_torch.models.asvgp import make_asvgp_core
    from gpsat_tpu_torch.models.vff import make_vff_core

    dev = _cuda()
    batch = _sgpr_batch(8, 256, 16, np.float32)
    out = {}
    for factor in ("block", "cholesky"):
        if model == "vff":
            core = make_vff_core(kernel="Matern32", num_inducing_features=4, factor=factor)
        else:
            core = make_asvgp_core(kernel="Matern12", num_inducing_features=8, factor=factor)
        before = {k: fn.launches for k, fn in (("block", BC.factor_blocks), ("cholesky", CH.cholesky))}
        runner = TE.make_batched_runner(core, fixed_params=core.default_fixed_params, max_iter=300, device=dev)
        out[factor] = TE.run_tile_batch(batch, {"smart_init": True}, runner, core, device=dev)
        launches = {"block": BC.factor_blocks.launches - before["block"],
                    "cholesky": CH.cholesky.launches - before["cholesky"]}
        it = int(out[factor]["num_iter"].max())
        want = {"block": it + 2, "cholesky": 0} if factor == "block" else {"block": 0, "cholesky": 0}
        assert launches == want, (factor, launches, want)
        assert out[factor]["converged"].sum() >= 7
    for key in ("f_mean", "f_var"):
        assert np.isfinite(out["block"][key]).all()
        assert float(np.abs(out["block"][key] - out["cholesky"][key]).max()) <= 1e-2, key


@pytest.mark.cuda
def test_host_gpr_model_f32_launches_kernel_1_and_f64_launches_nothing():
    # the verify recipe's drive on the card: 400 points, identity-padded to
    # 448 (7 launches per pair), one pair per evaluation of the single-eval
    # search ((it + 1) of them) and one in the predict
    import pandas as pd

    from gpsat_tpu_torch.models import get_model

    _cuda()
    rng = np.random.default_rng(0)
    x = rng.uniform(-3e5, 3e5, size=(400, 2))
    y = np.sin(x[:, 0] / 8e4) * np.cos(x[:, 1] / 1e5) + 0.05 * rng.normal(size=400)
    df = pd.DataFrame({"x": x[:, 0], "y": x[:, 1], "obs": y})
    kw = dict(data=df, coords_col=["x", "y"], obs_col="obs", coords_scale=[5e4, 5e4], obs_mean="local")
    cons = {"lengthscales": {"low": 0.1, "high": 20.0}}
    m32 = get_model("GPflowGPRModel")(**kw, dtype=torch.float32)
    m32.set_parameter_constraints(cons)
    before = BC.factor_blocks.launches
    assert m32.optimise_parameters()
    p32 = m32.predict(coords=np.zeros((1, 2)))
    torch.cuda.synchronize()
    assert BC.factor_blocks.launches - before == (m32._last_opt_result.num_iter + 2) * 7
    # f64 on the card takes the library arm: no launch, the CPU's numbers
    m64, cpu = (get_model("GPflowGPRModel")(**kw, device=dev) for dev in (None, "cpu"))
    for m in (m64, cpu):
        m.set_parameter_constraints(cons)
        m.set_parameters(**m32.get_parameters())
    before = BC.factor_blocks.launches
    p64, pc = m64.predict(coords=np.zeros((1, 2))), cpu.predict(coords=np.zeros((1, 2)))
    assert m64.get_objective_function_value() == pytest.approx(cpu.get_objective_function_value(), rel=1e-10)
    assert BC.factor_blocks.launches == before
    for k in ("f*", "f*_var", "y_var"):
        np.testing.assert_allclose(p64[k], pc[k], rtol=1e-10)
        np.testing.assert_allclose(p32[k], pc[k], atol=1e-2)


@pytest.mark.cuda
def test_autodiff_profiled_objective_factors_through_kernel_3():
    # RationalQuadratic's profiled objective in f32 on the card: one kernel-3
    # launch per value+grad (N = 256, in the kernel's domain) and none
    # in the backward (plain triangular solves); value and gradient against
    # the same function in f64 on the CPU, 1e-4 and 1e-2 relative (f32)
    from gpsat_tpu_torch.models import gpr as G
    from gpsat_tpu_torch.ops import transforms as TT

    dev = _cuda()
    rng = np.random.default_rng(3)
    B, N = 4, 256
    X = rng.uniform(-3, 3, (B, N, 2))
    y = np.sin(X[..., 0]) + 0.1 * rng.normal(size=(B, N))
    m = np.ones((B, N))
    m[:, 200:] = 0.0
    ls, tau = rng.uniform(0.6, 1.9, (B, 2)), rng.uniform(0.02, 0.2, B)
    bij = {k: TT.IDENTITY for k in ("lengthscales", "kernel_variance", "likelihood_variance")}

    def value_and_grad(device, dtype):
        t = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in
             dict(X=X, y=y, mask=m, ls=ls, tau=tau).items()}
        u = {"lengthscales": t["ls"].requires_grad_(True), "kernel_variance": torch.ones_like(t["tau"]),
             "likelihood_variance": t["tau"].requires_grad_(True)}
        v = G.neg_lml_profiled(u, {"X": t["X"], "y": t["y"], "mask": t["mask"]}, kernel="RationalQuadratic",
                               bijectors=bij, jitter=1e-5)
        g = torch.autograd.grad(v.sum(), [u["lengthscales"], u["likelihood_variance"]])
        return v.detach().double().cpu().numpy(), [x.double().cpu().numpy() for x in g]

    before = CH.cholesky.launches
    v32, g32 = value_and_grad(dev, torch.float32)
    torch.cuda.synchronize()
    assert CH.cholesky.launches - before == 1
    v64, g64 = value_and_grad("cpu", torch.float64)
    np.testing.assert_allclose(v32, v64, rtol=1e-4)
    for a, b in zip(g32, g64):
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-2 * np.abs(b).max())


@pytest.mark.cuda
def test_multioutput_models_launch_kernel_1_by_their_formulas():
    # MultioutputGPRModel on 100 points of P = 2 outputs: S of 200 padded
    # to 256, 4 launches per pair, (it + 2) pairs; MultioutputSVGPModel at
    # M = 32 (padded to 64): the L = 2 Kuu pairs in one launch per ELBO, one
    # per Adam step and one in the predict. f32 predictions within 1e-2 of
    # the f64 CPU model at the same parameters
    from gpsat_tpu_torch.models.multioutput import MultioutputGPRModel, MultioutputSVGPModel

    _cuda()
    rng = np.random.default_rng(1)
    X = rng.uniform(-4, 4, (100, 2))
    H = np.array([[1.0, 0.5], [0.2, 1.0]])
    Y = np.stack([np.sin(X[:, 0]), np.cos(X[:, 1] / 2)], axis=1) @ H.T + 0.05 * rng.normal(size=(100, 2))
    Xs = rng.uniform(-3, 3, (16, 2))
    cases = (
        (lambda dev, dt: MultioutputGPRModel(coords=X, obs=Y, H=H, likelihood_variance=0.01, device=dev, dtype=dt),
         lambda m: m.optimise_parameters(max_iter=50), lambda m: (int(m._last_opt_result.num_iter[0]) + 2) * 4),
        (lambda dev, dt: MultioutputSVGPModel(coords=X, obs=Y, H=H, num_inducing_points=32, device=dev, dtype=dt),
         lambda m: m.optimise_parameters(max_iter=20), lambda m: 20 + 1),
    )
    for make, fit, formula in cases:
        m32 = make(None, torch.float32)
        before = BC.factor_blocks.launches
        assert fit(m32)
        p32 = m32.predict(Xs)
        torch.cuda.synchronize()
        assert BC.factor_blocks.launches - before == formula(m32), type(m32).__name__
        cpu = make("cpu", torch.float64)
        cpu._params = dict(m32._params)
        pc = cpu.predict(Xs)
        for k in ("f*", "f*_var"):
            np.testing.assert_allclose(p32[k], pc[k], atol=1e-2, err_msg=f"{type(m32).__name__} {k}")


@pytest.mark.cuda
def test_mesh_naming_the_card_twice_matches_no_mesh_in_f64():
    # two shards on one card, each from its own host thread and stream: the
    # same f64 fit and predict as the whole batch with no mesh, to 1e-9
    _cuda()
    Bt, Nt, Pt, Dt = 9, 128, 8, 2
    rng = np.random.default_rng(5)
    X = rng.uniform(-6, 6, (Bt, Nt, Dt))
    y = np.sin(X[..., 0]) * np.cos(X[..., 1]) + 0.1 * rng.normal(size=(Bt, Nt))
    mask = np.ones((Bt, Nt))
    fill = rng.integers(int(0.6 * Nt), Nt + 1, size=Bt)
    for i, f in enumerate(fill):
        mask[i, f:] = 0.0
    batch = TileBatch(X=X, y=y, mask=mask, Xnew=rng.uniform(-4, 4, (Bt, Pt, Dt)), pred_mask=np.ones((Bt, Pt)),
                      obs_mean=np.zeros(Bt), expert_index=np.arange(Bt), num_obs=fill)
    core = make_gpr_core(jitter=1e-5)
    kw = dict(linesearch="single_eval", tol_grad=1e-6, tol_f=1e-11)
    res = {}
    for mesh in (None, ["cuda:0", "cuda:0"]):
        runner = TE.make_batched_runner(core, mesh=mesh, **kw)
        res[mesh is None] = TE.run_tile_batch(batch, {"smart_init": True}, runner, core, mesh=mesh)
    for key in ("f_mean", "f_var", "objective"):
        assert float(np.abs(res[False][key] - res[True][key]).max()) <= 1e-9, key
    np.testing.assert_array_equal(res[False]["converged"], res[True]["converged"])
    assert res[True]["converged"].all()


@pytest.mark.cuda
def test_launch_counter_adds_every_launch_from_two_threads():
    import threading

    dev = _cuda()
    K = torch.from_numpy(_spd(4, T, seed=2)).to(dev)
    torch.cuda.synchronize()  # K is ready before the side streams read it
    calls, threads = 500, []
    before = BC.factor_blocks.launches

    def launch():
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            for _ in range(calls):
                BC.factor_blocks(K)
            torch.cuda.current_stream(dev).synchronize()

    for _ in range(2):
        threads.append(threading.Thread(target=launch))
        threads[-1].start()
    for t in threads:
        t.join()
    assert BC.factor_blocks.launches - before == 2 * calls


@pytest.mark.cuda
def test_load_library_from_two_threads_builds_once(tmp_path, monkeypatch):
    import subprocess
    import threading

    from gpsat_tpu_torch.ops import _build

    _cuda()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)  # nothing built there yet
    monkeypatch.setattr(_build, "_libs", {})
    runs, real_run = [], subprocess.run

    def counted(cmd, *a, **k):
        runs.append(cmd[0])
        return real_run(cmd, *a, **k)

    monkeypatch.setattr(_build.subprocess, "run", counted)
    got = [None, None]

    def load(i):
        got[i] = _build.load_library("block_chol", BC._SYMBOLS)

    threads = [threading.Thread(target=load, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(runs) == 1 and got[0] is got[1] is not None
    assert len(list(tmp_path.glob("libblock_chol_*.so"))) == 1


def _mm_operands(batch, M, N, K, ta, tb, seed, dev, offset=0):
    # offset: a is x[:, :, offset:] of a contiguous x (offset 1: its base 4
    # bytes past a 16-byte boundary)
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((batch, K, M) if ta else (batch, M, K)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal((batch, N, K) if tb else (batch, K, N)).astype(np.float32)).to(dev)
    if offset:
        wide = torch.zeros(a.shape[:2] + (a.shape[2] + offset,), device=dev)
        wide[:, :, offset:] = a
        a = wide[:, :, offset:]
    return a, b


def _mm_scale(a, b, ta, tb):
    from gpsat_tpu_torch.ops import mm3xtf32 as MM

    return float(torch.matmul(MM._op(a, ta).abs().double(), MM._op(b, tb).abs().double()).max())


def _mm_bound(K):
    # the 3xTF32 product's error relative to max (|A||B|) (chip_smoke.py's
    # mm_bound): the split's 3 * 2^-22 and an f32 sum of K terms, 2 sqrt(K) 2^-24
    return 3 * 2.0**-22 + 2 * np.sqrt(K) * 2.0**-24


@pytest.mark.cuda
@pytest.mark.parametrize("batch,M,N,K,ta,tb,offset", [(3, 70, 90, 45, False, False, 0),
                                                      (2, 500, 500, 300, False, True, 0),
                                                      (1, 33, 65, 100, True, False, 0),
                                                      (2, 17, 129, 9, True, True, 0),
                                                      (8, 500, 1000, 500, False, False, 0),
                                                      (8, 500, 500, 4096, False, True, 0),
                                                      (8, 500, 4096, 500, True, False, 0),
                                                      (2, 300, 260, 2048, True, True, 0),
                                                      (2, 70, 90, 45, False, False, 1)])
def test_mm3xtf32_kernel_matches_the_plain_version(batch, M, N, K, ta, tb, offset):
    # ragged shapes (no multiple of the 128 x 128 tile or of the K step of
    # 32; the SGPR's M = 500), every orientation, the SGPR chunk's A A^T
    # (one wave of 128 tiles at K = 4,096) and its TN dKuf = W^T g, 18
    # tiles cut over K into 7 splits (ops/mm3xtf32.plan), and an operand
    # whose base is not 16-byte aligned (4-byte copies): against the
    # exact product within _mm_bound(K) of max (|A||B|), and against the
    # plain version (the same split, another f32 summation order) within
    # that bound plus the plain version's own error
    from gpsat_tpu_torch.ops import mm3xtf32 as MM

    dev = _cuda()
    a, b = _mm_operands(batch, M, N, K, ta, tb, seed=M + N + K, dev=dev, offset=offset)
    before = MM.mm3xtf32.launches
    C = MM.mm3xtf32(a, b, ta, tb)
    torch.cuda.synchronize()
    assert MM.mm3xtf32.launches == before + 1 and C.shape == (batch, M, N)
    scale = _mm_scale(a, b, ta, tb)
    exact = torch.matmul(MM._op(a, ta).double(), MM._op(b, tb).double())
    plain = MM.mm3xtf32_reference(a, b, ta, tb)
    err_plain = float((plain.double() - exact).abs().max()) / scale
    assert float((C.double() - exact).abs().max()) <= _mm_bound(K) * scale
    assert float((C - plain).abs().max()) <= (_mm_bound(K) + err_plain) * scale


@pytest.mark.cuda
def test_mm3xtf32_kernel_takes_strided_operands_and_refuses_the_rest():
    # a sliced W (the factor pair's [B, 500, 500] view of a [B, 512, 512]
    # buffer) needs no copy; f64 and a column-strided operand are refused
    from gpsat_tpu_torch.ops import mm3xtf32 as MM

    dev = _cuda()
    Wfull = torch.randn(4, 512, 512, device=dev)
    Kuf = torch.randn(4, 500, 300, device=dev)
    W = Wfull[:, :500, :500]
    exact = torch.matmul(W.double(), Kuf.double())
    assert float((MM.mm3xtf32(W, Kuf).double() - exact).abs().max()) <= _mm_bound(500) * _mm_scale(W, Kuf, False, False)
    with pytest.raises(TypeError):
        MM.mm3xtf32(W.double(), Kuf.double())
    with pytest.raises(ValueError):
        MM.mm3xtf32(Kuf.transpose(1, 2), Kuf)  # a column-strided operand: pass transpose_a instead


@pytest.mark.cuda
@pytest.mark.parametrize("ta,tb", [(False, False), (True, True)])
def test_mm3xtf32_kernel_keeps_nan_and_infinities_where_the_plain_version_has_them(ta, tb):
    # the split's fast rounding holds for finite values only: a thread whose
    # values hold an infinity or a NaN (the card's own, bits 0x7fffffff, as
    # inf - inf gives) rounds them as the plain version does
    from gpsat_tpu_torch.ops import mm3xtf32 as MM

    dev = _cuda()
    a, b = _mm_operands(1, 70, 90, 40, ta, tb, seed=3, dev=dev)
    a[0, 3, 5], b[0, 2, 7] = float("inf"), float("-inf")
    a.view(torch.int32)[0, 9, 1] = 0x7fffffff
    C = MM.mm3xtf32(a, b, ta, tb)
    ref = MM.mm3xtf32_reference(a, b, ta, tb)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(C), torch.isnan(ref)) and torch.equal(torch.isinf(C), torch.isinf(ref))
    # the finite entries against the exact product, within _mm_bound(K) of max (|A||B|)
    fin = torch.isfinite(ref)
    opa, opb = MM._op(a, ta).double(), MM._op(b, tb).double()
    exact = torch.matmul(opa, opb)
    scale = float(torch.matmul(opa.abs().nan_to_num(0, 0, 0), opb.abs().nan_to_num(0, 0, 0)).max())
    assert bool(fin.any()) and float((C.double()[fin] - exact[fin]).abs().max()) <= _mm_bound(40) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("ta,tb", [(False, False), (False, True), (True, False), (True, True)])
def test_mm3xtf32_backward_on_the_kernel_matches_autograd_of_the_plain_version(ta, tb):
    # MM3xTF32's backward runs the kernel (two launches) and gives the same
    # gradients as on the CPU (the plain version inside the same Function)
    # and as f64 autograd of the exact product, in f32 roundoff (the plain
    # version's bit rounding has no derivative of its own)
    from gpsat_tpu_torch.ops import mm3xtf32 as MM

    dev = _cuda()
    g = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 100, 70)).astype(np.float32))
    grads = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu")), ("f64", torch.device("cpu"))):
        a, b = _mm_operands(2, 100, 70, 130, ta, tb, seed=7, dev=device)
        if name == "f64":
            a, b = a.double(), b.double()
        a.requires_grad_(True)
        b.requires_grad_(True)
        out = (torch.matmul(MM._op(a, ta), MM._op(b, tb)) if name == "f64" else MM.MM3xTF32.apply(a, b, ta, tb))
        before = MM.mm3xtf32.launches
        grads[name] = [t.double().cpu() for t in torch.autograd.grad(out, (a, b), g.to(out))]
        if name == "card":
            torch.cuda.synchronize()
            assert MM.mm3xtf32.launches == before + 2
    for want in (grads["cpu"], grads["f64"]):
        for got, ref in zip(grads["card"], want):
            assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_sgpr_chunked_high_runs_the_split_on_the_card():
    # the chunked SGPR bound at accum_precision "high" on the card: the
    # relaxed products per chunk and their backward through the kernel (8
    # launches per chunk per value and gradient); its error against the f64
    # bound on the CPU within 3x that of "highest" on the card (the bound of
    # 2,048 points is a difference of terms ~40x its size, so each level's f32
    # roundoff moves it by ~1e-5 of itself); the unchunked bound launches none
    from gpsat_tpu_torch.models import sgpr as TS
    from gpsat_tpu_torch.ops import mm3xtf32 as MM

    dev = _cuda()
    rng = np.random.default_rng(3)
    B, N, M, C = 4, 2048, 100, 512
    X = torch.from_numpy(rng.uniform(0, 5, (B, N, 2)).astype(np.float32)).to(dev)
    y = torch.from_numpy(np.sin(X.cpu().numpy()[..., 0]).astype(np.float32)).to(dev)
    cp = {"lengthscales": torch.full((B, 2), 1.0, device=dev), "kernel_variance": torch.ones(B, device=dev),
          "likelihood_variance": torch.full((B,), 0.05, device=dev),
          "inducing_points": X[:, :M].clone()}
    data = {"X": X, "y": y, "mask": torch.ones(B, N, device=dev)}
    out = {}
    for level, chunk in (("high", C), ("highest", C), ("high", None)):
        params = {k: v.clone().requires_grad_(k != "inducing_points") for k, v in cp.items()}
        before = MM.mm3xtf32.launches
        e = TS.elbo(params, data, kernel="Matern32", chunk_size=chunk, accum_precision=level)
        (g,) = torch.autograd.grad(e.sum(), [params["lengthscales"]])
        torch.cuda.synchronize()
        out[(level, chunk)] = (e.detach(), g, MM.mm3xtf32.launches - before)
    assert out[("high", C)][2] == 8 * (N // C)
    assert out[("highest", C)][2] == 0 and out[("high", None)][2] == 0
    params = {k: v.double().cpu().requires_grad_(k != "inducing_points") for k, v in cp.items()}
    e64 = TS.elbo(params, {k: v.double().cpu() for k, v in data.items()}, kernel="Matern32", chunk_size=C)
    (g64,) = torch.autograd.grad(e64.sum(), [params["lengthscales"]])
    err = {level: (float((out[(level, C)][0].double().cpu() - e64.detach()).abs().max()) / float(e64.abs().max()),
                   float((out[(level, C)][1].double().cpu() - g64).abs().max()) / float(g64.abs().max()))
           for level in ("high", "highest")}
    assert err["high"][0] <= max(3 * err["highest"][0], 1e-6), err
    assert err["high"][1] <= max(3 * err["highest"][1], 1e-5), err
