"""Smoke run of the PyTorch/CUDA port (gpsat_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # one card; exits non-zero on any failure
    python3 chip_smoke.py --profile    # also write torch.profiler tables of one
                                       # main-path, panel-path, profiled-path,
                                       # oi, post, sgpr, svgp collapsed,
                                       # svgp Adam, zoo vff and zoo asvgp
                                       # run to
                                       # chiprun_out/profile*.txt, and split
                                       # kernel 3's time by __global__
    python3 chip_smoke.py --kernels    # phases 1 and 2 only (no result line)

Phases (each prints on its own lines; any failure raises):

1. build     compile gpsat_tpu_torch/csrc/{block_chol,panel_chol,cholesky,
             mm3xtf32}.cu with nvcc for sm_90a and the host library
             csrc/host/gpsat_native.cpp with g++, all five at once
2. kernel    each CUDA kernel against its plain PyTorch version on the card at
             the shapes its path gives it ([512, 64, 64], [512, 128, 128],
             [512, 512, 512] f32; kernel 3 also at [8, 1024, 1024] and
             [8, 128, 128]), its contract cases (NaN or clamp, the identity),
             and CUDA-event times of the kernel, the plain version and one
             library call as the yardstick; kernels 1 and 2 are also timed
             back to back (20 launches between one event pair), which leaves
             out the wrapper's host time; every kernel reports its blocks per
             SM, and with --profile kernel 3 its device time per __global__
             function; the 3xTF32 product (csrc/mm3xtf32.cu, the counterpart
             of XLA's Precision.HIGH dot) at phase 9 (b)'s chunk shapes, W Kuf
             ([8, 500, 500] x [8, 500, 4096], W a view of an [8, 512, 512]
             buffer), A A^T ([8, 500, 4096] x its transpose) and the TN dKuf
             = W^T g, against its plain version and the f64 product (its
             error at most the true-f32 torch.matmul's), each timed beside
             the plain version and torch.matmul
3. main      bench.py's workload (B=512, N=512, P=64, D=2, Matern32, f32,
             single-eval L-BFGS) through the port's engine on the "block"
             route: a warm-up call, then one timed call with the kernels'
             launch counters set to 0 before it and read after it
4. accuracy  the first 16 tiles, f32 on the card against f64 on the CPU
   f64       the same 16 tiles in f64 on the card on the "block", "panel" and
             "cholesky" routes (the library arm of each: the kernels take f32
             only, and no kernel may launch), each within 1e-5 of phase 4's
             CPU f64 result
5. panel     phase 3's workload on the "panel" route (kernel 2 in the
             objective, kernel 3 in the predict), held against phase 3's
             predictions
6. profiled  phase 3's workload through the profiled-variance core (kernel 3
             in the objective and in finalize_params, kernel 1 in the
             predict); the first 8 tiles against the same core in f64 on the
             CPU, on the lanes where neither run collapsed to the pure-noise
             point
7. oi        the orchestrator's sweep (gpsat_tpu_torch.experts.sweep, the
             exact-GPR lane that LocalExpertOI.run drives) at the pan-Arctic
             pipeline geometry of bench_pipeline.py: f32 on the card on the
             "block" route, then the f64 polish on the card; 16 experts'
             f32 predictions against an f64 fit on the CPU, and their polished
             predictions against the CPU's polish from the same f32 optima.
             It drives the sweep without a store; phase 16 drives the same
             geometry through LocalExpertOI.run and its results store
8. post      the flagship workflow after phase 7's geometry, on the card: (a)
             the f32 fit with unconverged-lane compaction (carry_iters 25,
             no polish), held against phase 7's f32 fit; (b) the
             hyperparameter fields smoothed with the settings of
             configs/sea_ice_freeboard_postprocessing.json, in f64 on the
             card, against the same smoothing on the CPU; (c) the
             predict-only re-run from the smoothed fields, 16 experts against
             the same re-run in f64 on the CPU; (d) the glue of all
             predictions, against a plain numpy weighted average
9. sgpr      the sparse-GPR lane at bench_large_n.py's geometry, M = 500
             inducing points (the reference's default), f32, kernel 1 in both
             factor pairs of every evaluation (Kuu and B = A A^T + I, 500
             identity-padded to 512), gradients through the pair: (a) B=32
             tiles of N=4,096 unchunked and (b) B=8 tiles of N=16,384 in four
             checkpointed chunks of 4,096, each a warm-up call and a timed
             call; (a) once more at accum_precision "high" (bit for bit (a):
             the unchunked bound has no relaxed product) and (b) at "high"
             (the chunk loop's W Kuf and A A^T through the 3xTF32 kernel, its
             launches held to a formula; 4 tiles against an f64 fit on the
             card, its f32 optima polished in f64 against that fit);
             (c) accuracy: 4 tiles of (a) fitted in f64 on the card,
             (a)'s f32 optima polished in f64 on the card against that fit,
             and 2 tiles of N=1,024 in f64 on the card against the CPU; (d)
             the factor pair in its new role on a Kuu of (a)'s first
             evaluation: kernel against plain version, and the gradient
             through the pair against f64 autograd through the library; (e)
             the replacement lane: phase 7's geometry through the sweep with
             SGPR (M = 64) for tiles of >= 64 observations and exact GPR for
             the rest, each lane against a sweep of its experts alone
10. svgp     the SVGP lane at bench_models.py's geometry (B=128, N=512, P=64,
             M = 64, jitter 1e-6, smart_init, f32, kernel 1 in every factor
             pair): (a) the collapsed bound (the Gaussian default), 4 tiles
             against the f64 fit on the card (the default zoom search); (b)
             Bernoulli labels by joint L-BFGS, 4 tiles against an f64 fit;
             (c) Adam + natural gradients (gamma 0.5, lr 1e-2), each lane's
             negative ELBO against (a)'s; each a short warm-up call and a
             timed call with its kernel-1 launches held to a formula; (d) an
             f64 GPR fit (B=16, N=128) with zoom and with backtracking, card
             against CPU and against the single-eval optimum; (e) the model
             block of configs/example_local_expert_oi_svgp.json through the
             sweep at phase 7's geometry, 16 experts against a CPU f64 sweep;
             and a diagnostic of (a)'s failed lanes: each re-run alone on
             the card through the library route in f32 and in f64
11. zoo      the collapsed inter-domain lanes at phase 7's geometry, f32 on
             the card, kernel 1 in P's factor pair of every evaluation: (a)
             the model block of configs/example_local_expert_oi_vff.json (VFF
             Matern32, M = 10: 361 features padded to 384, 6 launches per
             pair); (b) the same block with GPflowASVGPModel at its defaults
             (Matern12, 20 knots: 400 features padded to 448, 7 launches per
             pair); each with its launches held to a formula, 16 experts
             against an f64 fit of their tiles on the CPU, and that fit's
             bound and predictions in f64 on the card (the library arm)
             against the CPU's
12. host     the host-facing classes and the host-serial lane, on the card:
             (a) GPRModel on the verify recipe's 400 points (448 wide),
             SGPRModel on one tile of bench_large_n.py's N = 4,096 at M = 500
             (pairs of 512), SVGPModel's collapsed solver and VFFModel on the
             fullest expert of phase 7's data with the SVGP and VFF configs'
             model blocks (M = 64; 361 features padded to 384), ASVGPModel on
             the recipe's points at the lane's defaults (Matern12, 20 knots:
             400 features padded to 448): each fitted and predicted in f32
             (kernel 1, its launches held to a formula), held to its own f64
             fit on the CPU from the f32 optimum, and evaluated in f64 on the
             card at the CPU fit's parameters (no launch) against the CPU;
             (b) the sweep's host-serial lane over phase 7's first 64 experts
             with TorchGPRModel in f64 on the card against the same lane on
             the CPU, and with PureNumpyGPR (in a child process whose numpy
             BLAS keeps one thread, run beside (a)); (c) the torch.profiler
             trace that LocalExpertOI.run(profile_dir=...) writes, of a run
             on the host-serial lane over phase 7's first 8 experts with its
             results store in a temporary directory
13. prep     (a) phase 6's workload through the profiled core with
             RationalQuadratic, a kernel outside the fused set: its autodiff
             objective factors A with kernel 3 (gradients through the
             Cholesky's backward), finalize_params once more, the predict's
             pair on kernel 1; launches held to a formula, 8 tiles against
             the same core in f64 on the CPU; (b) MultioutputGPRModel and
             MultioutputSVGPModel on the verify recipe's 400 points, P = 2
             outputs of L = 2 latents (S of 800 padded to 832: 13 launches
             per pair; the two Kuu pairs of M = 64 in one launch), as
             phase 12's classes: f32 on the card with a launch formula,
             against an f64 CPU fit from the f32 optimum, and f64 on the
             card at that fit's parameters; (c) the data-preparation path
             in memory: a synthetic along-track day as CSV files read by
             ingest.read_flat_files (@to_datetime), projected with
             @WGS84toEASE2, binned on phase 7's 50 km grid by
             BinData.bin_wrapper (against a plain numpy group-by mean) and
             swept with phase 7's experts and GPR settings (kernel 1)
14. mesh     the experts sharded over devices (parallel.engine's mesh: one
             host thread and one stream per shard), at phase 7's geometry in
             f32 without the polish: (a) experts.sweep(mesh=default_mesh())
             on the one card, against phase 7's unmeshed f32 fit (the same
             arithmetic: <= 1e-6), kernel 1 launched (it_max + 2) * 2 times;
             (b) a mesh of two shards (every card when there are several,
             else the card twice: two threads, shards of 832), >= 90 %
             converged, kernel 1 launched sum over shards of
             (it_max_s + 2) * 2 times (the atomic launch counter), within
             1e-2 of (a) where both converged and the objectives agree
             within 1 nat; phase 7's first 64 experts in f64 on the card
             over the mesh against each shard's experts alone with no mesh
             at the shard's width (<= 1e-9), and against the whole bucket
             with no mesh lane by lane (the card's f64 triangular solve
             rounds by batch width: the same fit in another summation
             order, <= 1e-5, with at most 2 lanes stopping an iteration
             apart); the walls of (a) and (b)
             side by side (one card gains nothing from a second thread
             unless the host-bound loop hides behind the other's device
             work: a finding, not a claim); (c) two child processes joined
             over gloo on a localhost coordinator (gpsat_tpu_torch.
             distributed), started with the phase so that their imports and
             contexts overlap (a) and (b), each sweeping its
             partition_expert_locs share on its local mesh once the parent
             lets it and handing back its frames; the h5py-free merge
             (merge_frames) has (a)'s rows in (a)'s order, within 1e-2 of (a)
             where both converged, and the children's run tokens are equal.
             A mesh naming a missing card or mixing the CPU and CUDA raises,
             and so does a failed shard; a failed child fails the phase
15. xval     the host-side remainder: (a) the host library's grid-hash
             radius index against scipy's kdtree on phase 7's geometry (local
             select inclusive, prediction locations strict: equal sets, the
             host_select seconds of each arm) and phase 7's f32 sweep on
             each arm (equal predictions, kernel 1 launched (it_max + 2) * 2
             times on the grid's); (b) along-track data from synthetic.py
             (40 tracks of 150 points over 500 km, noise 0.05, a fold column
             track % 4) written as zarr stores of blosc lz4 chunks, byte- and
             bit-shuffled, read back through the dataloader (every column
             exact) and every chunk decoded by the C++ loops and the Python
             decoders (equal bytes); (c) xval.main on a reference config
             over that store (GPR Matern32, f32, 121 experts on the 100 km
             grid's nodes, radius 200 km), each of the four hold-out configs
             through LocalExpertOI's setters and the sweep on the card
             (>= 90 % converged, kernel 1 by the formula), 16 experts against
             an f64 fit of their tiles on the CPU from the card's optima (10
             iterations), and each fold's RMSE
             against the noise-free truth held to the same fold scored from
             the CPU's f64 predictions at the card's optima; (d)
             prime_cache.prime for a bucket of 121 experts (the libraries
             already built: 0 s each) and `python -m gpsat_tpu_torch.cli
             {xval,prime_cache} --help`
16. cli      the flagship workflow through its normal entry points, every
             store through the port's own HDF5 codec (no h5py): (a) phase
             7's inputs as files (the observations a .h5 store, the expert
             and prediction locations CSV) and a config with phase 7's model
             settings, run by `gpsat_tpu_torch.cli local_expert_oi` into a
             results.h5 (LocalExpertOI.run): kernel 1 launched (it_max + 2)
             * 2 times, phase 7's experts in run_details, the stored
             predictions within 1e-6 of phase 7's polished sweep where both
             converged, run's phase timers, the store's bytes; (b) `cli
             postprocessing` on that store with
             configs/sea_ice_freeboard_postprocessing.json's smoothing (the
             _SMOOTHED tables against smooth_table on the frames read back,
             <= 1e-12), the predict-only re-run it writes through `cli
             local_expert_oi` and load_params (kernel 1 launched 2 * 2
             times), and the glue of its stored predictions against a plain
             numpy weighted mean (<= 1e-12); (c) one table of 2,000,000
             along-track rows in eight columns appended in 20 blocks, read
             back whole and through a where on its datetime column, every
             column exact, write and read MB/s; (d) h5py never imported
17. formats  the readers' formats through the port's own HDF5 codec, with no
             h5py: (a) every fixture of tests/fixtures/hdf5 (PyTables tables
             uncompressed, zlib, blosc lz4 and bzip2; a PyTables results
             store; netCDF-4 files of HDF5's earliest format and of
             netCDF-C's: superblock 2, version-2 headers, dense links and
             attributes, chunked and filtered variables, phony dimensions,
             CF datetimes) read by pytables_compat.read_table and
             read_netcdf, each frame equal to expected.npz (the JAX
             package's h5py readers' frames), with the seconds of each read;
             (b) phase 16 (c)'s 2,000,000 rows as ten netCDF files written by
             DataLoader.write_to_netcdf and read back by `cli read_and_store`
             with the nc engine into a TableStore: every column exact (the
             datetimes by the CF decode's own float64 rule), write and read
             MB/s; (c) phase 7's observations as one .nc file, the data
             source of `cli local_expert_oi` at phase 7's geometry, read
             through DataLoader.load's netCDF branch: phase 16 (a)'s checks
             (phase 7's experts, kernel 1 launched (it_max + 2) * 2 times,
             stored predictions within 1e-6 of phase 7's polished sweep);
             (d) load_params from the PyTables results fixture over phase
             7's first 64 experts, a predict-only run: the loaded init and
             the stored parameters equal the fixture's values, kernel 1
             launched 2 * Nmax/64 times, and from its version-4 copy; (e)
             h5py never imported; (f) the lzf decoders, C++ and Python; (g)
             a version-4 read beside the same rows under v1.8; (h)
             LocalExpertOI.run restarted into copies of two results stores
             that gpsat_tpu's TableStore wrote through h5py (superblock 3,
             deflate+shuffle columns; superblock 2) and into the codec's
             superblock-0 copy of each: the stored rows unchanged, the new
             rows 0.0 from the copy's, kernel 1 launched alike; then
             200,000 rows appended to each store's predictions (MB/s); (a)
             also reads the codec's last formats: a shared-message table,
             a filtered fractal heap, 4-byte offsets, external and virtual
             variables, region references; (i) phase 7's observations from
             a virtual netCDF file (the fixture vds_obs.nc) over eight
             granule files the port's writer writes: the data source of `cli
             local_expert_oi`, (c)'s checks, and the virtual read holding
             every row exactly, timed beside the same rows read from one file

Then one {"kernels": [...]} line, and last {"ok": true, "device": {...}}.
Imports nothing of JAX or of gpsat_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM, TF32 on the tensor cores, dense
SECTOR_BYTES = 32  # the least the memory system moves at a time
B, N, P, D = 512, 512, 64, 2
T = 64
CPU_TILES = 16
PROFILED_CPU_TILES = 8
KERNELS = ("block_chol", "panel_chol", "cholesky", "mm3xtf32")
# the __global__ functions of those sources, as the profiler names them
OWN_KERNELS = ("cholinv64_kernel", "panel128_kernel", "chol_")
# f32 card vs f64 CPU on predictions: raw f32 optima sit ~3e-3 from f64 gold
# (flat optima; the repo's accuracy logs), so 1e-2 catches a wrong path
# without failing on f32 hyperparameter drift
PRED_BOUND = 1e-2
# two f32 runs on the card from the same init, on different factor routes:
# trajectories may part (other roundoff), each ends within the f32 band of the
# same flat optimum, so the same bound holds between them
ROUTE_BOUND = 1e-2
# a lane of the profiled surface that ran to the pure-noise stationary point
# (lengthscales -> 0, about one lane in eight): every lengthscale far below
# the ~0.5 spacing of the workload's points
COLLAPSED_LS = 0.05
# at least this share of the compared tiles must be lanes where neither the
# card's f32 run nor the CPU's f64 run collapsed
MIN_COMPARED_SHARE = 0.5
RUN_KW = dict(max_iter=100, linesearch="single_eval", tol_grad=1e-3, tol_f=1e-6)
# the f64 runs: phase 4's CPU reference and phase f64 on the card
CPU_F64_KW = dict(linesearch="single_eval", tol_grad=1e-6, tol_f=1e-11)
# f64 on the card vs f64 on the CPU, the same fit in another summation
# order: the north star's band for predictions
F64_BOUND = 1e-5
# phase 7: bench_pipeline.py's geometry and model config, not cut
OI_EXTENT, OI_BIN, OI_EXPERT_RES, OI_PRED_RES = 4_500_000.0, 50_000.0, 200_000.0, 25_000.0
OI_KW = dict(
    coords_col=["x", "y"],
    obs_col="z",
    local_select=[{"col": ["x", "y"], "comp": "<", "val": 300_000.0}],
    init_params={"kernel": "Matern32", "coords_scale": [50_000, 50_000], "obs_mean": "local",
                 "noise_variance": 0.0025, "smart_init": True, "jitter": 1e-5},
    constraints={"lengthscales": {"low": 5_000, "high": 2_000_000}},
    min_obs=10,
    pad_multiple=128,
)
OI_OPTIM = {"max_iter": 100, "polish": "f64"}
OI_MAX_DIST = 200_000.0
# an f64 reference fit whose objective is worse than the card's f32 fit's by
# more than this stopped on another, worse stationary point; f32 roundoff
# moves the objective of one optimum by ~1e-2 at these tile sizes
WORSE_OPTIMUM_NATS = 1.0
OI_MODE = "sweep"  # phase 7 drives the sweep; phase 16 drives the same geometry through LocalExpertOI.run
# phase 8: the fit's compaction, and the share of experts the checks must cover
POST_OPTIM = {"max_iter": 100, "carry_iters": 25}
MIN_SHARE = 0.9
SMOOTH_CONFIG = ROOT / "configs" / "sea_ice_freeboard_postprocessing.json"
# f64 on the card vs f64 on the CPU, the same weighted sums in another order
SMOOTH_REL_BOUND = 1e-10
GLUE_RADIUS, GLUE_R = 200_000.0, 3
# the glue against its plain numpy version: the same f64 sums in another order
GLUE_REL_BOUND = 1e-12
# phase 9: bench_large_n.py's SGPR geometry and settings, M = 500 the
# reference's default; (a) unchunked, (b) chunk_size "auto" (chunks of 4,096)
SGPR_M, SGPR_P = 500, 32
SGPR_FULL, SGPR_CHUNKED = (32, 4096), (8, 16384)
SGPR_RUN_KW = dict(max_iter=300, linesearch="single_eval", tol_grad=1e-3, tol_f=1e-6)
SGPR_F64_KW = dict(max_iter=1000, **CPU_F64_KW)
SGPR_F64_TILES = 4
SGPR_SMALL = (2, 1024)
# (b) again at accum_precision "high": the chunked loop's W Kuf and A A^T
# through the 3xTF32 kernel (csrc/mm3xtf32.cu). The kernel's phase 2 rows
# take (b)'s chunk shapes, MM_CHUNK being models.sgpr.DEFAULT_CHUNK: W Kuf of
# [B, M, M] x [B, M, C] and A A^T of [B, M, C] x its transpose (one operand
# twice: a diagonal of positive sums, the hardest case for an f32 sum).
# Against the exact f64 product, relative to max (|A||B|), the kernel is
# held to mm_bound(K): the split's 3 * 2^-22 per product (the dropped lo lo
# term and the rounding of lo) and an f32 sum of K terms in the random-walk
# model, 2 sqrt(K) 2^-24 (8.4e-6 at K = 4,096, 3.4e-6 at K = 500). The plain
# version splits alike and sums in another order (true-f32 cuBLAS
# products): the kernel is held to it within mm_bound(K) plus the plain
# version's own error against f64 in the same run. A true-f32 torch.matmul's
# error is logged beside (an error probe on one H100: kernel 0.9e-7-1.1e-6,
# plain 0.3e-6-5.8e-6, torch.matmul 0.3e-6-3.7e-6 over six operand kinds).
MM_CHUNK = 4096
# raw f32 optima against the f64 fit on the same tiles: the raw-f32 band of
# phase 4 (a CPU rehearsal on (a)'s first 4 tiles gave 7.8e-4; PERF.md
# section 6)
SGPR_RAW_BOUND = PRED_BOUND
# (d): the kernel pair against the plain pair on a Kuu of condition ~1e7 in
# f32, relative to the largest entry (the library pair differs from the plain
# one by 1.3e-3 on L and 2.8e-2 on W in the CPU rehearsal), and the backward
# errors |L L^T - K|, |L W - I| of the kernel pair
PAIR_REL_BOUND = {"L": 1e-2, "W": 2e-1}
PAIR_BACKWARD_BOUND = {"LLt": 1e-5, "LW": 1e-4}
# the f32 gradient through the pair against f64 autograd, relative to the
# largest entry: on that Kuu no f32 factor does better than ~0.3 (the
# library's f32 autograd, CPU rehearsal), so the pair is held to 3x the
# library's own error in the same run; on the same Kuu with 1e-2 kv added to
# its diagonal (condition ~1.5e4; rehearsal 1.9e-4) to 2e-3
GRAD_VS_LIBRARY = 3.0
GRAD_CONDITIONED_BOUND = 2e-3
GRAD_SHIFT = 1e-2
# (e): the replacement lane at phase 7's geometry
REPLACE_M, REPLACE_THRESHOLD = 64, 64
REPLACE_OPTIM = {"max_iter": 100}
# a lane against a sweep of its experts alone: the same buckets
REPLACE_BOUND = 1e-6
# phase 10: bench_models.py's SVGP geometry (make_batch, seed 0, fill
# 60-100 %), M = 64 (the SVGP config's), jitter 1e-6, smart_init, f32 with
# the engine's f32 defaults (single-eval, tol_grad 1e-3, tol_f 1e-6)
SVGP_B, SVGP_N, SVGP_P, SVGP_M = 128, 512, 64, 64
SVGP_JITTER = 1e-6
SVGP_MAX_ITER = {"collapsed": 500, "bernoulli": 1000}
SVGP_ADAM_KW = dict(max_iter=2000, learning_rate=1e-2, check_every=10, persistence=100)
SVGP_F64_TILES = 4
SVGP_F64_MAX_ITER = 2000
# (b): Bernoulli predictions of the f32 joint fit against the f64 fit of the
# same 4 tiles, in latent units (set from the CPU rehearsal, PERF.md
# section 6)
SVGP_BERNOULLI_BOUND = 0.2
# (c): each lane's final negative ELBO of Adam + natural gradients above
# (a)'s collapsed optimum by at most this many nats, and below it by at
# most SVGP_ELBO_BELOW (f32 roundoff of two bounds; set from the CPU
# rehearsal, PERF.md section 6)
SVGP_ELBO_ABOVE = 4.0
SVGP_ELBO_BELOW = 1.0
# (d): an f64 GPR fit with each probing search, card vs CPU (phase f64's
# agreement, 1.2e-8, for both searches) and against the single-eval f64
# optimum
LS_B, LS_N = 16, 128
LS_CARD_BOUND = 1.2e-8
SVGP_CONFIG = ROOT / "configs" / "example_local_expert_oi_svgp.json"
# (e): f32 and f64 objectives of one expert further apart than this are two
# stationary points, not one optimum in two precisions (f32 roundoff moves
# one optimum's objective by ~1e-2 nats at these tile sizes)
SVGP_SAME_OPTIMUM_NATS = 0.1
# phase 11 (zoo): the VFF config's model block at phase 7's geometry, and the
# same block with GPflowASVGPModel at the JAX package's ASVGP defaults
# (Matern12, 20 knots per dimension, margin 0.1)
VFF_CONFIG = ROOT / "configs" / "example_local_expert_oi_vff.json"
ZOO_ASVGP_DROP = ("kernel", "num_inducing_features", "domain_size")
# the f32 sweeps' iteration cap, cut from the config's 10,000: one lane that
# never meets its tolerance would hold the lockstep bucket for 10,000
# iterations (8-13 min at 50-80 ms each); the CPU rehearsal's slowest lane
# took 36 (VFF) and 44 (ASVGP) of them (PERF.md, section 4)
ZOO_MAX_ITER = 500
# the f64 fit of the compared experts on the CPU, from their f32 optima; a
# lane that has not converged by then is reported and not compared (the CPU
# rehearsal's converged lanes took <= 61)
ZOO_REF_MAX_ITER = 80
# the card's f64 bound and predictions (the library arm) at the CPU fit's
# parameters against the CPU's, relative to each value's scale (one f64
# function in two places; two f64 fits on a flat optimum drift further
# apart: 1.3e-8 over ASVGP's 56 iterations, measured on one H100)
ZOO_CARD_F64_BOUND = 1e-8


# phase 12 (host): the verify recipe's drive (.claude/skills/verify/SKILL.md)
# and the configs' model blocks, one expert per class; the f32 fits take the
# classes' f32 defaults (single-eval search, tol_grad 1e-3, tol_f 1e-6)
HOST_N, HOST_P = 400, 64
HOST_MAX_ITER = 300
# the f64 reference fit of each class on the CPU, from the card's f32 optimum:
# 10 iterations of the f64 single-eval search (SVGP's collapsed solver, which
# takes no search settings: of its zoom default); 20 took 5.49 s for SGPR's
# tile of 3,779 points on an H100 machine's host CPU (PERF.md, section 6)
HOST_REF_MAX_ITER = 10
# the card's f64 objective and predictions at the CPU fit's parameters
# against the CPU's, relative to each value's scale: one f64 function in two
# places, as phase 11's check
HOST_CARD_F64_BOUND = 1e-8
# (b): the host-serial lane over the first experts of phase 7's geometry;
# TorchGPRModel's f64 card run against its f64 CPU run, the same 30 Adam
# steps per expert in another summation order
HOST_LANE_EXPERTS = 64
HOST_LANE_BOUND = 1e-6
# PureNumpyGPR's lane runs in a child process whose numpy BLAS (OpenBLAS)
# keeps one thread: at its default thread count the tiny solves of ~100-point
# tiles took 38.72 s for the 64 experts on an H100 machine's host CPU, 80x a
# one-thread run in a CPU rehearsal; the child's start-up took 7.8 s of its
# 9.68 s there (PERF.md, section 6), so it runs beside (a)
PURE_NUMPY_ENV = {"OPENBLAS_NUM_THREADS": "1"}
# (c): a short traced sweep (the trace of every op of 8 experts' 30 Adam
# steps took 20.8 MB in a CPU rehearsal)
HOST_TRACE_EXPERTS, HOST_TRACE_STEPS = 8, 5
# phase 13 (prep): (a) the profiled core with a kernel outside the fused set
PREP_PROFILED_KERNEL = "RationalQuadratic"
# (b) the multi-output models on the verify recipe's 400 points (coordinates
# in units of its 50 km coords_scale): P = 2 outputs of L = 2 latents mixed
# by tests/test_multioutput.py's H, S of 800 padded to 832 (13 launches per
# pair); SVGP at M = 64, its Adam run cut to MO_ADAM_STEPS of the class's
# 1,000 at its learning rate (PERF.md, section 4)
MO_H = np.array([[1.0, 0.5], [0.2, 1.0]])
MO_SCALE = 5e4
MO_M = 64
MO_GPR_MAX_ITER = 300
MO_ADAM_STEPS, MO_ADAM_LR = 500, 0.02
# the f64 references on the CPU from the card's f32 optimum: 10 zoom
# iterations for GPR, 10 Adam steps at a 1e-4 learning rate for SVGP (each
# unconstrained param moves by at most 1e-3)
MO_REF_ITERS, MO_REF_LR = 10, 1e-4
# (c) the data-preparation path in memory: a synthetic along-track day of
# PREP_TRACKS tracks of PREP_TRACK_POINTS points in lon/lat, binned on phase
# 7's 50 km grid; the binned means against a plain numpy group-by mean
PREP_TRACKS, PREP_TRACK_POINTS = 28, 3000
PREP_BIN_BOUND = 1e-12
# phase 14: the meshed sweep against phase 7's (the same arithmetic on one
# shard), f32 shards against (a) within the raw-f32 band, and meshed f64
# against unmeshed f64: against the shards' experts alone (the same widths,
# the same bits: MESH_F64_BOUND) and, lane by lane, against the whole
# bucket. The card's f64 triangular solve rounds by batch width, and the
# L-BFGS runs near flat optima carry that to 4.1e-8 where num_iter is equal
# and to 1.58e-7 on a lane that stops an iteration apart: the same fit in
# another summation order, held to F64_BOUND, with at most
# MESH_F64_ITER_LANES lanes at another num_iter (one in each of three runs)
MESH_SAME_BOUND = 1e-6
MESH_F64_EXPERTS = 64
MESH_F64_BOUND = 1e-9
MESH_F64_ITER_LANES = 2
MESH_CHILDREN = 2
MESH_BUDGET_S = 30.0
MESH_OPTIM = {"max_iter": OI_OPTIM["max_iter"]}
# phase 15 (xval): the host library, the zarr / blosc readers and
# cross-validation on along-track data. (b): synthetic.make_tracks' tracks
# through make_ground_truth_field's field (the JAX package's defaults but
# 150 points per track), noise 0.05, written as zarr stores of blosc lz4
# chunks of XVAL_CHUNK rows; (c): GPR Matern32 on every hold-out fold, the
# experts on the 100 km grid_2d_flatten grid's nodes (11 x 11)
HOST_LIBRARY = "gpsat_native"
XVAL_EXTENT, XVAL_TRACKS, XVAL_TRACK_POINTS, XVAL_FIELD_N = 500_000.0, 40, 150, 181
XVAL_NOISE, XVAL_FOLDS, XVAL_CHUNK = 0.05, 4, 1024
XVAL_EXPERT_RES, XVAL_RADIUS = 100_000.0, 200_000.0
XVAL_MODEL = {"oi_model": "GPflowGPRModel",
              "init_params": {"kernel": "Matern32", "coords_scale": [50_000, 50_000], "noise_variance": 0.0025,
                              "smart_init": True, "jitter": 1e-5},
              "constraints": {"lengthscales": {"low": 5_000, "high": 2_000_000}},
              "optim_kwargs": {"max_iter": 100}}
# each fold's RMSE against the noise-free truth, the card's f32 predictions
# against the CPU's f64 predictions at the card's optima (the same
# hyperparameters: only f32 roundoff remains), relative
XVAL_RMSE_REL = 1e-2
# the f64 reference fit of 16 experts on the CPU, from the card's f32 optima
# (phases 12 and 13's rule): this many iterations of the f64 search
XVAL_REF_MAX_ITER = 10
XVAL_BUDGET_S = 30.0
PRIME_SHAPES = [(121, 512, 64)]
# phase 16: the workflow through its entry points at phase 7's geometry.
# (a) LocalExpertOI.run builds phase 7's tiles in phase 7's order and runs
# the same arithmetic on them, so its stored predictions are held to phase
# 7's sweep as phase 14 (a) holds the default mesh: the same fit
CLI_SAME_BOUND = 1e-6
# (b) the stored smoothing against smooth_table on the frames read back:
# the same function on the same inputs
CLI_SMOOTH_BOUND = 1e-12
# (c) a month of along-track observations as read_and_store writes them:
# eight columns, appended in blocks
STORE_ROWS, STORE_BLOCKS, STORE_SOURCES = 2_000_000, 20, 12
CLI_BUDGET_S = 45.0
# phase 17: the readers' formats. The PyTables results fixture holds phase
# 7's first FORMATS_EXPERTS experts (tools/make_hdf5_fixtures.py)
FORMATS_EXPERTS = 64
FORMATS_DIR = ROOT / "tests" / "fixtures" / "hdf5"
# (b) phase 16 (c)'s rows written as this many netCDF files
FORMATS_FILES = 10
FORMATS_BUDGET_S = 60.0
# (d) the results fixture's version-4 copy; (f) the lzf fixture
FORMATS_V4_RESULTS, FORMATS_LZF, FORMATS_LZF_REPS = "v4_results_store.h5", "v4_lzf.nc", 20
# (g) each timing the median of this many repeats, after one untimed
FORMATS_READ_REPS = 15
# (i) phase 7's observations as a virtual netCDF file (the fixture) whose
# variables map consecutive rows of this many granule files, named
# relative to it
FORMATS_VDS, FORMATS_VDS_GRANULES = "vds_obs.nc", 8
# (h) results stores that h5py wrote (tools/make_hdf5_fixtures.py: the JAX
# TableStore over h5py, at libver "latest" with deflate+shuffle columns and
# at "v108" unfiltered), each the first half of restart_oi's run over phase
# 7's experts FORMATS_RESTART_EXPERTS; then rows appended to a store's
# predictions, filtered and not
FORMATS_RESTART_STORES = ("restart_latest_gzip.h5", "restart_v108.h5")
FORMATS_RESTART_EXPERTS = slice(3, 11)
FORMATS_APPEND_ROWS, FORMATS_APPEND_BLOCKS = 200_000, 4
# (d) an f32 predict-only run stores the loaded parameters after their
# constraint transform and back in f32: a few f32 ulps (4.4e-7 relative on
# the CPU), relative
FORMATS_STORED_REL = 2e-6
# a phase 14 (c) child: argv is the repo root, its process id, the process
# count, the coordinator's port and the directory for its frames
MESH_CHILD_CODE = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke as cs; "
                   "cs.mesh_child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(phase, **kw):
    # numpy scalars print as their Python values
    print(json.dumps({"phase": phase, **kw}, default=lambda o: o.item()), flush=True)


def time_ms(fn, reps=20, warm=3):
    """Median of per-call CUDA-event times (ms)."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bench_workload(dtype=np.float32):
    """bench.py's workload and explicit init (seed 0, 60-100 % fill)."""
    from gpsat_tpu_torch.parallel.batching import TileBatch

    rng = np.random.default_rng(0)
    X = rng.uniform(-6, 6, size=(B, N, D)).astype(dtype)
    y = (np.sin(X[..., 0]) * np.cos(X[..., 1]) + 0.1 * rng.normal(size=(B, N))).astype(dtype)
    mask = np.ones((B, N), dtype=dtype)
    fill = rng.integers(int(0.6 * N), N + 1, size=B)
    for i, f in enumerate(fill):
        mask[i, f:] = 0.0
    Xnew = rng.uniform(-4, 4, size=(B, P, D)).astype(dtype)
    batch = TileBatch(
        X=X, y=y, mask=mask, Xnew=Xnew, pred_mask=np.ones((B, P), dtype=dtype),
        obs_mean=np.zeros(B, dtype=dtype), expert_index=np.arange(B), num_obs=fill,
    )
    var_y = np.nanvar(np.where(mask > 0, y, np.nan), axis=1)
    init = {
        "lengthscales": np.nanstd(np.where(mask[..., None] > 0, X, np.nan), axis=1),
        "kernel_variance": var_y,
        "likelihood_variance": 0.1 * var_y,
    }
    return batch, init


def spd_batch(Bn, n, seed):
    """[Bn, n, n] f32 SPD matrices on the card: A A^T + n I, entries O(sqrt n)."""
    import torch

    A = torch.from_numpy(np.random.default_rng(seed).standard_normal((Bn, n, n)).astype(np.float32)).cuda()
    return torch.matmul(A, A.transpose(1, 2)) + n * torch.eye(n, device=A.device)


def factor_bytes(Bn, n, outputs):
    """Least bytes a factor of [Bn, n, n] f32 moves: the input's lower
    triangle read in whole 32-byte sectors (rows start on a sector), and
    ``outputs`` full n x n matrices written (their zero upper triangles too)."""
    per_sector = SECTOR_BYTES // 4
    read = sum(-(-(r + 1) // per_sector) for r in range(n)) * SECTOR_BYTES
    return Bn * (read + outputs * n * n * 4)


def kernel_entry(name, source, replaces, shape, err, ms, plain_ms, library_ms, nbytes, flops, row_extra=None,
                 flops_per_s=F32_FLOPS_PER_S, **details):
    """One row of the {"kernels": [...]} line, with the kernel's bound: the
    larger of its bytes (what the function must read once and write once,
    ``factor_bytes``) over the card's memory rate and its operations over
    the peak of the units they run on (``flops_per_s``: the f32 peak, or
    the TF32 tensor cores'). ``row_extra`` adds keys to the row;
    ``details`` go to the log line only."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flops_per_s * 1e3
    log("kernel", name=name, shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms, **(row_extra or {}), **details)
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        **(row_extra or {}),
    }


def back_to_back_ms(fn, launches=20, reps=5):
    """Median over ``reps`` of (one event pair around ``launches`` calls) /
    ``launches``: the kernel's own time once the host runs ahead of it."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def device_ms_by_kernel(fn, match, calls=5):
    """Device time per call (ms) of each CUDA kernel whose name contains
    ``match``, from torch.profiler over ``calls`` calls of ``fn`` after one
    warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / calls for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and match in e.key}


def upper_is_zero(*mats):
    import torch

    return all(float(torch.triu(M, 1).abs().max()) == 0.0 for M in mats)


def phase_kernel(BC):
    import torch

    K = spd_batch(B, T, seed=0)
    L, W = BC.factor_blocks(K)
    torch.cuda.synchronize()
    Lr, Wr = BC.factor_blocks_reference(K)
    err_L = float((L - Lr).abs().max())
    err_W = float((W - Wr).abs().max())
    eye = torch.eye(T, device=K.device)
    err_LW = float((torch.matmul(L, W) - eye).abs().max())
    # f32, 64 dependent steps, FMA-contracted in the kernel and not in the
    # plain version; L entries are O(10): 1e-4 absolute
    check(err_L <= 1e-4 and err_W <= 1e-4, f"block kernel vs plain version: |dL| {err_L}, |dW| {err_W}")
    check(err_LW <= 1e-4, f"block kernel: max |LW - I| = {err_LW}")
    check(upper_is_zero(L, W), "block kernel: strict upper triangles not zero")
    bad = torch.stack([eye, -eye]).contiguous()
    Ln, Wn = BC.factor_blocks(bad)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(Ln[0]).all()) and bool(torch.isnan(Ln[1]).any()) and bool(torch.isnan(Wn[1]).any()),
          "a -I block must give NaN in L and W, an I block beside it finite values")
    check(torch.equal(Ln[0], eye) and torch.equal(Wn[0], eye), "an identity block must come back exactly")

    def library():
        Lc, _ = torch.linalg.cholesky_ex(K)
        return torch.linalg.solve_triangular(Lc, eye.expand(B, T, T), upper=False)

    # least work: read K's lower triangle once, write L and W once; Cholesky
    # T^3/3 + inverse T^3/3 flops
    return kernel_entry(
        "block_chol.factor_blocks", "gpsat_tpu_torch/csrc/block_chol.cu", "gpsat_tpu/ops/pallas/block_chol.py:50",
        [B, T, T], max(err_L, err_W), time_ms(lambda: BC.factor_blocks(K)),
        time_ms(lambda: BC.factor_blocks_reference(K)), time_ms(library),
        nbytes=factor_bytes(B, T, 2), flops=B * (2.0 / 3.0) * T**3,
        row_extra={"ms_back_to_back": back_to_back_ms(lambda: BC.factor_blocks(K)),
                   "library_ms_back_to_back": back_to_back_ms(library), "blocks_per_sm": BC.blocks_per_sm()},
        err_L=err_L, err_W=err_W, max_abs_LW_minus_I=err_LW, nan_case="ok", identity_case="ok",
    )


def phase_kernel_panel(PC):
    import torch

    TP = PC.T_PANEL
    K = spd_batch(B, TP, seed=1)
    L, W = PC.factor_panels(K)
    torch.cuda.synchronize()
    Lr, Wr = PC.factor_panels_reference(K)
    err_L = float((L - Lr).abs().max())
    err_W = float((W - Wr).abs().max())
    eye = torch.eye(TP, device=K.device)
    err_LW = float((torch.matmul(L, W) - eye).abs().max())
    err_LLt = float((torch.matmul(L, L.transpose(1, 2)) - K).abs().max())
    # f32, 128 dependent steps, FMA-contracted in the kernel and not in the
    # plain version; L entries are O(10), Linv entries O(0.1), K entries up to
    # ~300: the bounds the JAX package holds its kernel to (2e-4 on L, 2e-5 on
    # L Linv - I), 2e-5 on Linv, and 1e-5 of K's entries on L L^T
    check(err_L <= 2e-4 and err_W <= 2e-5, f"panel kernel vs plain version: |dL| {err_L}, |dW| {err_W}")
    check(err_LW <= 2e-5, f"panel kernel: max |L Linv - I| = {err_LW}")
    check(err_LLt <= 2e-3, f"panel kernel: max |L L^T - K| = {err_LLt}")
    check(upper_is_zero(L, W), "panel kernel: strict upper triangles not zero")
    # the contract is the 1e-30 pivot clamp: an all-zero block gives finite
    # values equal to the plain version's, the identity block beside it is exact
    odd = torch.stack([torch.zeros_like(eye), eye]).contiguous()
    Lz, Wz = PC.factor_panels(odd)
    torch.cuda.synchronize()
    Lzr, Wzr = PC.factor_panels_reference(odd)
    check(bool(torch.isfinite(Lz).all()) and bool(torch.isfinite(Wz).all()), "an all-zero block must give finite values")
    check(torch.allclose(Lz, Lzr, rtol=1e-6, atol=0) and torch.allclose(Wz, Wzr, rtol=1e-6, atol=0),
          "the clamp case differs from the plain version")
    check(torch.equal(Lz[1], eye) and torch.equal(Wz[1], eye), "an identity block must come back exactly")

    def library():
        Lc, _ = torch.linalg.cholesky_ex(K)
        return torch.linalg.solve_triangular(Lc, eye.expand(B, TP, TP), upper=False)

    return kernel_entry(
        "panel_chol.factor_panels", "gpsat_tpu_torch/csrc/panel_chol.cu", "gpsat_tpu/ops/pallas/panel_chol.py:41",
        [B, TP, TP], max(err_L, err_W), time_ms(lambda: PC.factor_panels(K)),
        time_ms(lambda: PC.factor_panels_reference(K), reps=5, warm=1), time_ms(library),
        nbytes=factor_bytes(B, TP, 2), flops=B * (2.0 / 3.0) * TP**3,
        row_extra={"ms_back_to_back": back_to_back_ms(lambda: PC.factor_panels(K)),
                   "library_ms_back_to_back": back_to_back_ms(library)},
        err_L=err_L, err_W=err_W, max_abs_LLinv_minus_I=err_LW, max_abs_LLt_minus_K=err_LLt, clamp_case="ok",
        blocks_per_sm=PC.blocks_per_sm(),
    )


def phase_kernel_cholesky(CH, profile: bool):
    import torch

    def compare(Bn, n, seed):
        K = spd_batch(Bn, n, seed)
        L = CH.cholesky(K)
        torch.cuda.synchronize()
        err = float((L - CH.cholesky_reference(K)).abs().max())
        err_LLt = float((torch.matmul(L, L.transpose(1, 2)) - K).abs().max())
        # f32 roundoff of this factorisation against f64 is ~2e-5 on L
        # (entries up to ~50) and ~1e-6 of K's entries (up to ~2n) on L L^T:
        # 2e-4 absolute against the plain version, 1e-5 of n on L L^T
        check(err <= 2e-4, f"cholesky kernel vs plain version at {[Bn, n, n]}: {err}")
        check(err_LLt <= 1e-5 * n, f"cholesky kernel: max |L L^T - K| at {[Bn, n, n]} = {err_LLt}")
        check(upper_is_zero(L), f"cholesky kernel: strict upper triangle not zero at {[Bn, n, n]}")
        return K, err, err_LLt

    K, err, err_LLt = compare(B, N, seed=2)
    edges = {str([Bn, n, n]): compare(Bn, n, seed=3)[1] for Bn, n in ((8, 1024), (8, 128))}
    eye = torch.eye(N, device=K.device)
    Ln = CH.cholesky(torch.stack([eye, -eye]).contiguous())
    torch.cuda.synchronize()
    check(torch.equal(Ln[0], eye) and bool(torch.isnan(Ln[1]).any()),
          "a -I matrix must give NaN, an I matrix beside it must come back exactly")

    # the host entry's __global__ functions (diagonal with its panel, trailing)
    split = device_ms_by_kernel(lambda: CH.cholesky(K), "chol_") if profile else None
    return kernel_entry(
        "cholesky.cholesky", "gpsat_tpu_torch/csrc/cholesky.cu", "gpsat_tpu/ops/pallas/cholesky.py:90",
        [B, N, N], err, time_ms(lambda: CH.cholesky(K)),
        time_ms(lambda: CH.cholesky_reference(K), reps=3, warm=1), time_ms(lambda: torch.linalg.cholesky_ex(K)),
        nbytes=factor_bytes(B, N, 1), flops=B * N**3 / 3.0,
        row_extra={"blocks_per_sm": CH.blocks_per_sm(), "device_ms_by_kernel": split},
        max_abs_LLt_minus_K=err_LLt, edge_max_abs_err=edges, nan_case="ok",
    )


def mm_bound(K):
    """The 3xTF32 product's error bound relative to max (|A||B|) at inner
    dimension K (MM_CHUNK's comment)."""
    return 3 * 2.0**-22 + 2 * np.sqrt(K) * 2.0**-24


def mm_errors(MM, a, b, ta, tb, C):
    """max |C - plain| and, relative to max (|A||B|), the errors of C, of
    the plain version and of a true-f32 torch.matmul against the f64
    product, and |C - plain|."""
    import torch

    opa, opb = MM._op(a, ta), MM._op(b, tb)
    scale = float(torch.matmul(opa.abs().double(), opb.abs().double()).max())
    exact = torch.matmul(opa.double(), opb.double())
    plain = MM.mm3xtf32_reference(a, b, ta, tb)
    rel64 = {k: float((v.double() - exact).abs().max()) / scale
             for k, v in (("kernel", C), ("plain", plain), ("matmul_f32", torch.matmul(opa, opb)))}
    return float((C - plain).abs().max()), float((C - plain).abs().max()) / scale, rel64


def phase_kernel_mm3xtf32(MM):
    """The 3xTF32 product at phase 9 (b)'s chunk shapes, W Kuf (W the
    factor pair's [8, 500, 500] view of an [8, 512, 512] buffer, as the
    chunk loop passes it), A A^T and the backward's TN dKuf = W^T g, against
    its plain version and the f64 product; at each its error against f64 is
    at most the true-f32 torch.matmul's, and each is timed beside the plain
    version and torch.matmul with its bound. The card's process-wide TF32
    switch must stay off."""
    import torch

    Bm, M, C = SGPR_CHUNKED[0], SGPR_M, MM_CHUNK
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    pair = torch.from_numpy(rng.standard_normal((Bm, 512, 512)).astype(np.float32)).to(dev)
    W = pair[:, :M, :M]
    Kuf = torch.from_numpy(rng.standard_normal((Bm, M, C)).astype(np.float32)).to(dev)
    A = torch.from_numpy(rng.standard_normal((Bm, M, C)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((Bm, M, C)).astype(np.float32)).to(dev)
    cases = {"w_kuf": (W, Kuf, False, False), "a_at": (A, A, False, True), "d_kuf": (W, g, True, False)}
    rows = {}
    for tag, (a, b, ta, tb) in cases.items():
        out = MM.mm3xtf32(a, b, ta, tb)
        torch.cuda.synchronize()
        err, rel, rel64 = mm_errors(MM, a, b, ta, tb, out)
        K = b.shape[2] if tb else b.shape[1]
        N = b.shape[1] if tb else b.shape[2]
        bound = mm_bound(K)
        check(tuple(out.shape) == (Bm, M, N) and bool(torch.isfinite(out).all()),
              f"mm3xtf32 {tag}: shape {tuple(out.shape)} or non-finite values")
        check(rel64["kernel"] <= bound, f"mm3xtf32 {tag} vs the f64 product: {rel64['kernel']} of max |A||B|")
        check(rel <= bound + rel64["plain"], f"mm3xtf32 {tag} vs its plain version: {rel} of max |A||B|")
        check(rel64["kernel"] <= rel64["matmul_f32"],
              f"mm3xtf32 {tag}: {rel64['kernel']} of max |A||B| against f64, above torch.matmul's "
              f"{rel64['matmul_f32']}")
        opa, opb = MM._op(a, ta), MM._op(b, tb)
        plan = MM.plan(Bm, M, N, K, (a.data_ptr(), a.stride(1), a.stride(0)),
                       (b.data_ptr(), b.stride(1), b.stride(0)), MM._sm_count(dev))
        nbytes = 4 * (Bm * M * K + (0 if b is a else Bm * K * N) + out.numel())
        flops = 3 * 2.0 * Bm * M * N * K
        rows[tag] = dict(
            shape=[Bm, M, N, K], transpose=[ta, tb], max_abs_err=err, rel_err=rel, rel_bound=bound,
            rel_err_vs_f64=rel64["kernel"], plain_rel_err_vs_f64=rel64["plain"],
            matmul_f32_rel_err_vs_f64=rel64["matmul_f32"], splits=plan.splits, blocks=plan.blocks,
            ms=time_ms(lambda: MM.mm3xtf32(a, b, ta, tb)),
            ms_back_to_back=back_to_back_ms(lambda: MM.mm3xtf32(a, b, ta, tb)),
            plain_ms=time_ms(lambda: MM.mm3xtf32_reference(a, b, ta, tb), reps=5),
            library_ms=time_ms(lambda: torch.matmul(opa, opb)),
            bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / TF32_FLOPS_PER_S) * 1e3, nbytes=nbytes, flops=flops)
        rows[tag]["tflops_issued"] = flops / rows[tag]["ms"] / 1e9
    check(not torch.backends.cuda.matmul.allow_tf32 and torch.get_float32_matmul_precision() == "highest",
          "the process-wide TF32 switch was turned on")
    w = rows["w_kuf"]
    extra = {"ms_back_to_back": w["ms_back_to_back"],
             "max_rel_err": max(r["rel_err"] for r in rows.values()),
             "max_rel_err_vs_f64": max(r["rel_err_vs_f64"] for r in rows.values()),
             "plain_max_rel_err_vs_f64": max(r["plain_rel_err_vs_f64"] for r in rows.values()),
             "matmul_f32_max_rel_err_vs_f64": max(r["matmul_f32_rel_err_vs_f64"] for r in rows.values())}
    for tag in ("a_at", "d_kuf"):
        extra.update({f"{k}_{tag}": rows[tag][k] for k in ("ms", "ms_back_to_back", "plain_ms", "library_ms",
                                                            "bound_ms")})
    return kernel_entry(
        "mm3xtf32.mm3xtf32", "gpsat_tpu_torch/csrc/mm3xtf32.cu",
        "gpsat_tpu/models/sgpr.py:139 (XLA's Precision.HIGH dot, no Pallas kernel)", w["shape"],
        max(r["max_abs_err"] for r in rows.values()), w["ms"], w["plain_ms"], w["library_ms"],
        nbytes=w["nbytes"], flops=w["flops"], flops_per_s=TF32_FLOPS_PER_S, row_extra=extra, cases=rows)


def counters():
    from gpsat_tpu_torch.ops.block_chol import factor_blocks
    from gpsat_tpu_torch.ops.cholesky import cholesky
    from gpsat_tpu_torch.ops.mm3xtf32 import mm3xtf32
    from gpsat_tpu_torch.ops.panel_chol import factor_panels

    return {"block_chol": factor_blocks, "panel_chol": factor_panels, "cholesky": cholesky, "mm3xtf32": mm3xtf32}


def drive(phase, core, batch, init, profile_to=None):
    """One path at the full width through the engine: a warm-up call, then
    one timed call with every kernel's launch count set to 0 just before it
    and read just after. Returns (results, launches by kernel)."""
    import torch

    from gpsat_tpu_torch.parallel.engine import make_batched_runner, run_tile_batch
    from gpsat_tpu_torch.utils.flops import gpr_fused_iter_flops, gpr_predict_flops

    runner = make_batched_runner(core, fixed_params=core.default_fixed_params, **RUN_KW)
    t0 = time.perf_counter()
    run_tile_batch(batch, init, runner, core)
    first_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = run_tile_batch(batch, init, runner, core)  # finalize() copies to host: synchronised
    steady_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}

    conv = int(res["converged"].sum())
    it_max = int(res["num_iter"].max())
    flops = B * it_max * gpr_fused_iter_flops(N, D) + B * gpr_predict_flops(N, P, D)
    log(phase, core=core.name, experts_per_s=B / steady_s, steady_s=steady_s, first_call_s=first_s, converged=conv, B=B,
        iters_mean=float(res["num_iter"].mean()), iters_max=it_max, stall_exits=int(res["stalled"].sum()),
        failed_exits=int(res["failed"].sum()), achieved_tflops=flops / steady_s / 1e12,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches)
    check(np.isfinite(res["f_mean"]).all() and np.isfinite(res["f_var"]).all(), f"{phase}: non-finite predictions")
    check(conv >= 0.9 * B, f"{phase}: only {conv}/{B} lanes converged")

    if profile_to:
        trace(phase, lambda: run_tile_batch(batch, init, runner, core), profile_to)
    return res, launches, it_max


def trace(phase, fn, profile_to):
    """One traced call of ``fn``: its profiler table goes to
    chiprun_out/``profile_to``, its device busy share and the port's own
    kernels' device time to the log."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    events = prof.key_averages()
    # the kernels' own rows only (an aten op's row repeats the time of
    # the kernels it launched); one stream, so kernels do not overlap
    device_s = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA) / 1e6
    own = {e.key: e.self_device_time_total / 1e6 for e in events
           if e.device_type == DeviceType.CUDA and any(k in e.key for k in OWN_KERNELS)}
    table = events.table(sort_by="self_device_time_total", row_limit=25)
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / profile_to).write_text(table)
    print(table, flush=True)
    log("profile", path=phase, traced_s=traced_s, device_busy_s=device_s, device_busy_share=device_s / traced_s,
        own_kernels_device_s=own, own_kernels_share_of_device=sum(own.values()) / device_s if device_s else None)
    check(0.0 < device_s <= traced_s, f"device busy {device_s} s of a {traced_s} s traced call")


def phase_main(batch, init, profile: bool):
    from gpsat_tpu_torch.models.functional import make_gpr_core

    res, launches, it_max = drive("main", make_gpr_core(jitter=1e-5), batch, init, "profile.txt" if profile else None)
    # 8 diagonal blocks per factor pair; one pair per L-BFGS value+grad (the
    # initial one plus one per iteration of the slowest lane) and one in predict
    expected = {"block_chol": (it_max + 2) * (N // T), "panel_chol": 0, "cholesky": 0, "mm3xtf32": 0}
    check(launches == expected, f"main path launches {launches}, expected {expected}")
    return res, launches["block_chol"]


def phase_accuracy(batch, init):
    import torch

    from gpsat_tpu_torch.models.functional import make_gpr_core
    from gpsat_tpu_torch.parallel.batching import cast_batch, take_batch
    from gpsat_tpu_torch.parallel.engine import make_batched_runner, run_tile_batch

    idx = np.arange(CPU_TILES)
    sub = take_batch(batch, idx)
    sub_init = {k: v[idx] for k, v in init.items()}
    core = make_gpr_core(jitter=1e-5)
    gpu = run_tile_batch(sub, sub_init, make_batched_runner(core, **RUN_KW), core)
    t0 = time.perf_counter()
    cpu = run_tile_batch(
        cast_batch(sub, np.float64), {k: v.astype(np.float64) for k, v in sub_init.items()},
        make_batched_runner(core, device="cpu", **CPU_F64_KW), core, device="cpu",
    )
    cpu_s = time.perf_counter() - t0
    dmean = float(np.abs(gpu["f_mean"] - cpu["f_mean"]).max())
    dvar = float(np.abs(gpu["f_var"] - cpu["f_var"]).max())
    log("accuracy", tiles=CPU_TILES, max_abs_dmean=dmean, max_abs_dvar=dvar, bound=PRED_BOUND,
        converged_gpu=int(gpu["converged"].sum()), converged_cpu_f64=int(cpu["converged"].sum()), cpu_f64_s=cpu_s,
        torch_threads=torch.get_num_threads())
    check(dmean <= PRED_BOUND and dvar <= PRED_BOUND, f"card vs CPU f64: dmean {dmean}, dvar {dvar}")
    return sub, sub_init, cpu


def phase_f64(sub, sub_init, cpu):
    """Phase 4's tiles in f64 on the card, on the block, panel and cholesky
    routes with phase 4's CPU f64 settings: the kernels take f32 only, so f64
    takes the library arm of each route and launches no kernel. Each route
    is held against phase 4's CPU f64 result."""
    import torch

    from gpsat_tpu_torch.models.functional import make_gpr_core
    from gpsat_tpu_torch.parallel.batching import cast_batch
    from gpsat_tpu_torch.parallel.engine import make_batched_runner, run_tile_batch

    batch64 = cast_batch(sub, np.float64)
    init64 = {k: v.astype(np.float64) for k, v in sub_init.items()}
    for factor in ("block", "panel", "cholesky"):
        core = make_gpr_core(jitter=1e-5, factor=factor)
        runner = make_batched_runner(core, **CPU_F64_KW)
        for fn in counters().values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = run_tile_batch(batch64, init64, runner, core)
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters().items()}
        dmean = float(np.abs(res["f_mean"] - cpu["f_mean"]).max())
        dvar = float(np.abs(res["f_var"] - cpu["f_var"]).max())
        log("f64", factor=factor, tiles=len(sub.X), seconds=seconds, max_abs_dmean=dmean, max_abs_dvar=dvar,
            bound=F64_BOUND, converged=int(res["converged"].sum()), iters_max=int(res["num_iter"].max()),
            launches=launches, dtype=str(res["f_mean"].dtype))
        check(res["f_mean"].dtype == np.float64 and np.isfinite(res["f_mean"]).all() and np.isfinite(res["f_var"]).all(),
              f"f64 on the card, {factor} route: predictions not finite f64")
        check(dmean <= F64_BOUND and dvar <= F64_BOUND, f"f64 card vs CPU, {factor} route: dmean {dmean}, dvar {dvar}")
        check(not any(launches.values()), f"f64 on the {factor} route launched a kernel: {launches}")
    torch.cuda.synchronize()


def phase_panel(batch, init, main_res, profile: bool):
    from gpsat_tpu_torch.models.functional import make_gpr_core
    from gpsat_tpu_torch.ops.panel_chol import T_PANEL

    res, launches, it_max = drive("panel", make_gpr_core(jitter=1e-5, factor="panel"), batch, init,
                                  "profile_panel.txt" if profile else None)
    # 4 diagonal 128-blocks per factor pair, one pair per value+grad; the
    # predict factors once with the full Cholesky kernel and never with kernel 1
    expected = {"block_chol": 0, "panel_chol": (it_max + 1) * (N // T_PANEL), "cholesky": 1, "mm3xtf32": 0}
    check(launches == expected, f"panel path launches {launches}, expected {expected}")
    dmean = float(np.abs(res["f_mean"] - main_res["f_mean"]).max())
    dvar = float(np.abs(res["f_var"] - main_res["f_var"]).max())
    log("panel_vs_block", max_abs_dmean=dmean, max_abs_dvar=dvar, bound=ROUTE_BOUND,
        same_num_iter=int((res["num_iter"] == main_res["num_iter"]).sum()))
    check(dmean <= ROUTE_BOUND and dvar <= ROUTE_BOUND, f"panel vs block route: dmean {dmean}, dvar {dvar}")
    return launches["panel_chol"]


def phase_profiled(batch, init, profile: bool, kernel="Matern32", tag="profiled"):
    """The profiled core on phase 3's workload: Matern32 through the fused
    objective (phase 6), RationalQuadratic through the autodiff one (phase
    13 (a)); kernel 3 factors A in both. Returns kernel 3's launches, with
    kernel 1's as a second value."""
    from gpsat_tpu_torch.models.functional import make_gpr_core
    from gpsat_tpu_torch.parallel.batching import cast_batch, take_batch
    from gpsat_tpu_torch.parallel.engine import make_batched_runner, run_tile_batch

    core = make_gpr_core(kernel=kernel, jitter=1e-5, profile_variance=True)
    res, launches, it_max = drive(tag, core, batch, init, f"profile_{tag}.txt" if profile else None)
    # one full Cholesky per value+grad and one in finalize_params; the predict
    # takes the "block" pair: 8 launches of kernel 1
    expected = {"block_chol": N // T, "panel_chol": 0, "cholesky": it_max + 2, "mm3xtf32": 0}
    log(f"{tag}_launches", launches=launches, launches_predicted=expected,
        formula="cholesky: iters_max + 2, block_chol: N / 64")
    check(launches == expected, f"{tag} path launches {launches}, expected {expected}")

    idx = np.arange(PROFILED_CPU_TILES)
    sub = take_batch(batch, idx)
    sub_init = {k: v[idx].astype(np.float64) for k, v in init.items()}
    t0 = time.perf_counter()
    cpu = run_tile_batch(
        cast_batch(sub, np.float64), sub_init,
        make_batched_runner(core, fixed_params=core.default_fixed_params, linesearch="single_eval",
                            tol_grad=1e-6, tol_f=1e-11, device="cpu"),
        core, device="cpu",
    )
    cpu_s = time.perf_counter() - t0
    collapsed_all = int((res["lengthscales"].max(-1) < COLLAPSED_LS).sum())
    keep = ~((res["lengthscales"][idx].max(-1) < COLLAPSED_LS) | (cpu["lengthscales"].max(-1) < COLLAPSED_LS))
    check(keep.sum() >= MIN_COMPARED_SHARE * len(idx), f"only {int(keep.sum())}/{len(idx)} tiles collapsed on neither side")
    dmean = float(np.abs(res["f_mean"][idx] - cpu["f_mean"])[keep].max())
    dvar = float(np.abs(res["f_var"][idx] - cpu["f_var"])[keep].max())
    log(f"{tag}_accuracy", tiles=len(idx), compared=int(keep.sum()), collapsed_lanes_of_B=collapsed_all,
        max_abs_dmean=dmean, max_abs_dvar=dvar, bound=PRED_BOUND, converged_cpu_f64=int(cpu["converged"].sum()),
        cpu_f64_s=cpu_s)
    check(dmean <= PRED_BOUND and dvar <= PRED_BOUND, f"{tag}, card vs CPU f64: dmean {dmean}, dvar {dvar}")
    return launches["cholesky"], launches["block_chol"]


def cell_centers(res):
    """Cell centres of a res-sized grid over the pipeline's square domain, x
    fastest (bench_pipeline.py's grid_2d_flatten)."""
    edges = np.linspace(-OI_EXTENT, OI_EXTENT, int(2 * OI_EXTENT / res) + 1)
    c = (edges[:-1] + edges[1:]) / 2.0
    X, Y = np.meshgrid(c, c)
    return X.ravel(), Y.ravel()


def pipeline_inputs():
    """bench_pipeline.py's data, numpy seed 0: a binned field at 50 km cells
    with ~55 % occupancy, experts on the 200 km grid, a 25 km prediction
    grid. Columns are dicts of arrays."""
    rng = np.random.default_rng(0)
    cx, cy = cell_centers(OI_BIN)
    occupancy = (
        np.sin(cx / 1.1e6) * np.cos(cy / 1.4e6)
        + 0.6 * rng.standard_normal(len(cx)) * 0  # draws kept: they fix the seed's stream
        + rng.uniform(0, 1, len(cx))
    ) > 0.45
    cx, cy = cx[occupancy], cy[occupancy]
    z = (
        0.3 * np.sin(cx / 8e5) * np.cos(cy / 6e5)
        + 0.2 * np.sin((cx + cy) / 1.5e6)
        + 0.05 * rng.standard_normal(len(cx))
    )
    ex, ey = cell_centers(OI_EXPERT_RES)
    px, py = cell_centers(OI_PRED_RES)
    return {"x": cx, "y": cy, "z": z}, {"x": ex, "y": ey}, {"x": px, "y": py}


def phase_oi(profile: bool):
    """The sweep at the pipeline geometry, f32 on the card with kernel 1 in
    every evaluation, then the f64 polish on the card (no kernel: f64 takes
    the library arm). Kernel launch counts are set to 0 just before the sweep
    and read just after it. Returns kernel 1's launches, the f32 fit's
    predictions and objectives by expert, its slowest lane's iterations, and
    the polished predictions as a preds table with each expert's converged
    flag (phase 16's reference)."""
    import torch

    from gpsat_tpu_torch.data import select as sel
    from gpsat_tpu_torch.data.prediction_locations import PredictionLocations
    from gpsat_tpu_torch.experts import core_for, initial_cparams, sweep
    from gpsat_tpu_torch.parallel import batching
    from gpsat_tpu_torch.parallel.engine import make_batched_runner, polish_tile_batch, run_tile_batch

    obs, experts, grid = pipeline_inputs()

    def run(timers):
        pred_loc = PredictionLocations("from_dataframe", coords_col=["x", "y"], df=grid, max_dist=OI_MAX_DIST)
        return list(sweep(obs, experts, pred_loc=pred_loc, optim_kwargs=OI_OPTIM, timers=timers, **OI_KW))

    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    timers = {}
    t0 = time.perf_counter()
    out = run(timers)
    wall_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}

    skipped = [r for r in out if r.get("skipped")]
    buckets = [r for r in out if not r.get("skipped")]
    n_skipped = sum(len(r["expert_index"]) for r in skipped)
    cat = {k: np.concatenate([r[k] for r in buckets]) for k in ("expert_index", "converged", "num_iter", "stalled",
                                                                 "failed", "num_obs")}
    coarse = {k: np.concatenate([r["coarse"][k] for r in buckets]) for k in ("converged", "num_iter", "stalled",
                                                                            "failed")}
    n = len(cat["expert_index"])
    f_finite = all(np.isfinite(r["f_mean"]).all() and np.isfinite(r["f_var"]).all() for r in buckets)
    # one factor pair of [B, Nmax, Nmax] per f32 value+grad (the initial one,
    # one per iteration of the slowest lane) and one in the predict: Nmax/64
    # launches each; the f64 polish launches none
    nmax = batching.bucket_size(int(cat["num_obs"].max()))
    expected = {"block_chol": sum((int(r["coarse"]["num_iter"].max()) + 2) * nmax // T for r in buckets),
                "panel_chol": 0, "cholesky": 0, "mm3xtf32": 0}
    log("oi", mode=OI_MODE, experts=len(experts["x"]), run=n, skipped=n_skipped, buckets=len(buckets),
        observations=len(obs["x"]), prediction_points=int(sum(r["pred_mask"].sum() for r in buckets)),
        nmax_obs=int(cat["num_obs"].max()), wall_s=wall_s, experts_per_s=n / wall_s,
        phases_s=timers, converged_f32=int(coarse["converged"].sum()),
        iters_f32_mean=float(coarse["num_iter"].mean()), iters_f32_max=int(coarse["num_iter"].max()),
        stall_exits_f32=int(coarse["stalled"].sum()), failed_exits_f32=int(coarse["failed"].sum()),
        converged_polish=int(cat["converged"].sum()), iters_polish_mean=float(cat["num_iter"].mean()),
        iters_polish_max=int(cat["num_iter"].max()), stall_exits_polish=int(cat["stalled"].sum()),
        failed_exits_polish=int(cat["failed"].sum()), launches=launches)
    check(f_finite, "oi: non-finite predictions")
    check(coarse["converged"].sum() >= 0.9 * n, f"oi: only {int(coarse['converged'].sum())}/{n} f32 lanes converged")
    check(cat["converged"].sum() >= 0.9 * n, f"oi: only {int(cat['converged'].sum())}/{n} polished lanes converged")
    check(launches == expected, f"oi launches {launches}, expected {expected}")

    # 16 experts spread over the run: their tiles again, on the CPU
    pick = np.sort(cat["expert_index"])[:: max(n // CPU_TILES, 1)][:CPU_TILES]
    sub_experts = {c: v[pick] for c, v in experts.items()}
    ix = sel.local_select_indices_all(obs, sub_experts, OI_KW["local_select"])
    pcs = PredictionLocations("from_dataframe", coords_col=["x", "y"], df=grid, max_dist=OI_MAX_DIST).batch_call(
        sub_experts)
    ip, cons = OI_KW["init_params"], OI_KW["constraints"]
    tiles = batching.assemble_tiles(
        sel.columns_array(obs, ["x", "y"]), obs["z"], ix, pcs, expert_index=pick,
        coords_scale=ip["coords_scale"], obs_mean=ip["obs_mean"])
    check(len(tiles) == 1, f"oi: the compared experts' tiles fill {len(tiles)} buckets, not one")
    batch = tiles[0]
    core = core_for(ip, cons)
    t0 = time.perf_counter()
    cpu = run_tile_batch(batch, initial_cparams(core, ip, cons, 2), make_batched_runner(core, device="cpu", **CPU_F64_KW),
                         core, device="cpu")
    cpu_s = time.perf_counter() - t0
    coarse_all = {k: np.concatenate([r["coarse"][k] for r in buckets]) for k in ("expert_index", *core.param_names)}
    t0 = time.perf_counter()
    cpu_polish = polish_tile_batch(batch, coarse_all, core, max_iter=150, device="cpu")
    cpu_polish_s = time.perf_counter() - t0

    def card(key, which):
        """The card's rows for the picked experts, each cut to its P_i."""
        rows = {}
        for r in buckets:
            src = r["coarse"] if which == "coarse" else r
            for j, e in enumerate(src["expert_index"]):
                rows[int(e)] = src[key][j]
        return rows

    def diffs(ref, which):
        """Per compared expert, max |card - ref| over f_mean and f_var."""
        out = np.zeros(len(ref["expert_index"]))
        for key in ("f_mean", "f_var"):
            got = card(key, which)
            for j, e in enumerate(ref["expert_index"]):
                p = int(ref["pred_mask"][j].sum())
                out[j] = max(out[j], float(np.abs(got[int(e)][:p] - ref[key][j][:p]).max()))
        return out

    # the single-eval f64 fit from the shared init can stop on a worse
    # stationary point than the f32 fit found (the JAX package's f64 fit
    # stops on the same one): compare the experts where it did not, and
    # only where the card's f32 objective is the better one by > 1 nat
    card_obj = card("objective", "coarse")
    f32_obj = np.asarray([card_obj[int(e)] for e in cpu["expert_index"]], dtype=np.float64)
    worse_ref = cpu["objective"] > f32_obj + WORSE_OPTIMUM_NATS
    d_f32, d_polish = diffs(cpu, "coarse"), diffs(cpu_polish, "polished")
    log("oi_accuracy", experts=len(pick), f32_vs_cpu_f64=float(d_f32[~worse_ref].max()), f32_bound=PRED_BOUND,
        compared=int((~worse_ref).sum()), reference_on_worse_optimum={
            int(e): {"cpu_f64_objective": float(cpu["objective"][j]), "card_f32_objective": float(f32_obj[j]),
                     "max_abs_diff": float(d_f32[j])} for j, e in enumerate(cpu["expert_index"]) if worse_ref[j]},
        polish_card_vs_cpu=float(d_polish.max()), polish_bound=F64_BOUND, cpu_f64_s=cpu_s,
        cpu_polish_s=cpu_polish_s, converged_cpu_f64=int(cpu["converged"].sum()),
        converged_cpu_polish=int(cpu_polish["converged"].sum()))
    check((~worse_ref).sum() >= MIN_COMPARED_SHARE * len(pick),
          f"oi: the CPU f64 fit stopped on a worse optimum on {int(worse_ref.sum())}/{len(pick)} experts")
    check(d_f32[~worse_ref].max() <= PRED_BOUND, f"oi: card f32 vs CPU f64 on {len(pick)} experts: {d_f32}")
    check(d_polish.max() <= F64_BOUND, f"oi: card polish vs CPU polish on {len(pick)} experts: {d_polish.max()}")
    if profile:
        trace("oi", lambda: run({}), "profile_oi.txt")
    f32 = {}
    for r in buckets:
        c = r["coarse"]
        for j, e in enumerate(c["expert_index"]):
            p = int(c["pred_mask"][j].sum())
            f32[int(e)] = {"num_iter": int(c["num_iter"][j]), "objective": float(c["objective"][j]),
                           "f_mean": c["f_mean"][j][:p], "f_var": c["f_var"][j][:p]}
    polished = {"preds": preds_frame(buckets, experts),
                "converged": {int(e): bool(c) for r in buckets for e, c in zip(r["expert_index"], r["converged"])}}
    return launches["block_chol"], f32, int(coarse["num_iter"].max()), polished


def by_expert(buckets, keys):
    """{expert: {key: value}} over a sweep's buckets; predictions cut to
    the expert's P_i."""
    out = {}
    for r in buckets:
        for j, e in enumerate(r["expert_index"]):
            p = int(r["pred_mask"][j].sum())
            out[int(e)] = {k: (r[k][j][:p] if k in ("f_mean", "f_var", "y_var") else r[k][j]) for k in keys}
    return out


def max_abs_pred_diff(a, b, rows=slice(None)):
    """max |a - b| over f_mean and f_var of two per-expert records, or of
    ``rows`` of two results."""
    return max(float(np.abs(np.asarray(a[k])[rows] - np.asarray(b[k])[rows]).max()) for k in ("f_mean", "f_var"))


def kernel1_launches(buckets, nmax):
    """Kernel 1's launches for a sweep's buckets, derived from the code: one
    factor pair of Nmax/64 launches per value+grad (the initial one, one per
    iteration of a run's slowest lane) and one in each run's predict; a
    carry bucket runs the head and, when it has unconverged lanes, the tail
    (which evaluates again at the carried iterate); a predict-only bucket
    runs one objective and one predict."""
    runs = []
    for r in buckets:
        c = r.get("compaction")
        if c is None:
            runs.append(int(r["num_iter"].max()))
            continue
        runs.append(int(c["head_num_iter"].max()))
        if c["tail_width"]:
            runs.append(int(c["tail_num_iter"].max()))
    return sum(it + 2 for it in runs) * (nmax // T)


def preds_frame(buckets, experts):
    """The results store's preds table (pandas) from a sweep's buckets:
    one row per expert and prediction location, the expert's coordinates
    beside it."""
    import pandas as pd

    parts = []
    for r in buckets:
        P_i = r["pred_mask"].sum(axis=1).astype(int)
        prefix = np.arange(r["pred_mask"].shape[1])[None, :] < P_i[:, None]
        pc = np.concatenate([np.asarray(c)[:p] for c, p in zip(r["pred_coords"], P_i)])
        e = np.repeat(r["expert_index"], P_i)
        parts.append(pd.DataFrame({
            "x": experts["x"][e], "y": experts["y"][e], "pred_loc_x": pc[:, 0], "pred_loc_y": pc[:, 1],
            "f*": r["f_mean"][prefix], "f*_var": r["f_var"][prefix], "y_var": r["y_var"][prefix],
            "f_bar": np.repeat(r["obs_mean"], P_i),
        }))
    return pd.concat(parts, ignore_index=True)


def glue_numpy(preds, radius, R, var):
    """Plain weighted average of ``var`` per prediction location: the
    product of the two axes' normal densities (sigma = radius / R) around
    each expert, summed with np.bincount."""
    s = radius / R
    px, py = preds["pred_loc_x"].to_numpy(), preds["pred_loc_y"].to_numpy()
    w = (np.exp(-0.5 * ((px - preds["x"].to_numpy()) / s) ** 2) / (s * np.sqrt(2 * np.pi))
         * np.exp(-0.5 * ((py - preds["y"].to_numpy()) / s) ** 2) / (s * np.sqrt(2 * np.pi)))
    locs, ids = np.unique(np.stack([px, py], axis=1), axis=0, return_inverse=True)
    ids = ids.ravel()
    return locs, np.bincount(ids, weights=w * preds[var].to_numpy()) / np.bincount(ids, weights=w)


def phase_post(f32_oi, f32_it_max, profile: bool):
    """Phase 8: fit (compaction) -> smooth -> predict-only re-run -> glue at
    the pipeline geometry. Kernel launch counts are set to 0 just before the
    fit and before the re-run, and read just after each. Returns kernel 1's
    launches in the fit and in the re-run."""
    import torch

    from gpsat_tpu_torch.data.prediction_locations import PredictionLocations
    from gpsat_tpu_torch.experts import sweep
    from gpsat_tpu_torch.parallel import batching
    from gpsat_tpu_torch.parallel.engine import padded_width
    from gpsat_tpu_torch.postprocess import SmoothingConfig, glue_local_predictions, smooth_table

    obs, experts, grid = pipeline_inputs()
    seconds = {}

    def pred_loc():
        return PredictionLocations("from_dataframe", coords_col=["x", "y"], df=grid, max_dist=OI_MAX_DIST)

    timers = {"fit": {}, "repredict": {}}

    def fit(timers=None):
        return [r for r in sweep(obs, experts, pred_loc=pred_loc(), optim_kwargs=POST_OPTIM, timers=timers, **OI_KW)
                if not r.get("skipped")]

    # (a) the fit, the lanes the head leaves unconverged resumed in a tail
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    buckets = fit(timers["fit"])
    seconds["fit"] = time.perf_counter() - t0
    launches_fit = {k: fn.launches for k, fn in counters().items()}
    cat = {k: np.concatenate([r[k] for r in buckets]) for k in ("expert_index", "converged", "num_iter", "stalled",
                                                                 "failed", "num_obs")}
    n = len(cat["expert_index"])
    nmax = batching.bucket_size(int(cat["num_obs"].max()))
    comp = [r["compaction"] for r in buckets]
    head_iters = np.concatenate([c["head_num_iter"] for c in comp])
    tail_iters = np.concatenate([c["tail_num_iter"] for c in comp])
    billed = sum(c["head_width"] * int(c["head_num_iter"].max()) + c["tail_width"] * int(
        c["tail_num_iter"].max(initial=0)) for c in comp)
    billed_oi = padded_width(n, OI_KW["pad_multiple"]) * f32_it_max
    fit_by = by_expert(buckets, ("num_iter", "objective", "f_mean", "f_var"))
    common = sorted(set(fit_by) & set(f32_oi))
    same_iter = sum(fit_by[e]["num_iter"] == f32_oi[e]["num_iter"] for e in common)
    d_obj = {e: abs(fit_by[e]["objective"] - f32_oi[e]["objective"]) for e in common}
    other_optimum = {e: {"post_objective": fit_by[e]["objective"], "oi_objective": f32_oi[e]["objective"]}
                     for e in common if d_obj[e] > WORSE_OPTIMUM_NATS}
    compared = [e for e in common if d_obj[e] <= WORSE_OPTIMUM_NATS]
    d_fit = max(max_abs_pred_diff(fit_by[e], f32_oi[e]) for e in compared) if compared else float("inf")
    expected = {"block_chol": kernel1_launches(buckets, nmax), "panel_chol": 0, "cholesky": 0, "mm3xtf32": 0}
    log("post_fit", experts=n, buckets=len(buckets), seconds=seconds["fit"], phases_s=timers["fit"],
        head_width=[c["head_width"] for c in comp], tail_width=[c["tail_width"] for c in comp],
        tail_lanes=[len(c["tail_rows"]) for c in comp], head_iters_mean=float(head_iters.mean()),
        head_iters_max=int(head_iters.max()), tail_iters_mean=float(tail_iters.mean()) if len(tail_iters) else None,
        tail_iters_max=int(tail_iters.max(initial=0)), iters_mean=float(cat["num_iter"].mean()),
        iters_max=int(cat["num_iter"].max()), converged=int(cat["converged"].sum()),
        stall_exits=int(cat["stalled"].sum()), failed_exits=int(cat["failed"].sum()),
        lane_iterations_billed=billed, lane_iterations_billed_phase7=billed_oi,
        billed_share_of_phase7=billed / billed_oi, same_num_iter_as_phase7=same_iter, compared=len(common),
        max_abs_pred_diff_vs_phase7=d_fit, pred_bound=PRED_BOUND, other_optimum=other_optimum,
        launches=launches_fit)
    check(cat["converged"].sum() >= MIN_SHARE * n and not cat["failed"].any(),
          f"post fit: {int(cat['converged'].sum())}/{n} converged, {int(cat['failed'].sum())} failed")
    check(len(common) == n == len(f32_oi), f"post fit: {n} experts run, {len(f32_oi)} in phase 7")
    check(same_iter >= MIN_SHARE * n, f"post fit: num_iter equal to phase 7's on {same_iter}/{n} experts")
    check(len(compared) >= MIN_SHARE * n, f"post fit: objectives differ by > 1 nat on {len(other_optimum)}/{n}")
    check(d_fit <= PRED_BOUND, f"post fit vs phase 7 f32 predictions: {d_fit}")
    check(launches_fit == expected, f"post fit launches {launches_fit}, expected {expected}")

    # (b) the hyperparameter fields, clipped and smoothed per slice
    import pandas as pd

    with open(SMOOTH_CONFIG) as f:
        smooth_cfg = json.load(f)["smooth_config_dict"]
    params = by_expert(buckets, ("lengthscales", "kernel_variance", "likelihood_variance"))
    rows = np.asarray(sorted(params))
    ex, ey = experts["x"][rows], experts["y"][rows]
    loaded, d_smooth, seconds["smooth"], seconds["smooth_cpu"] = {}, 0.0, 0.0, 0.0
    for name, cfg in smooth_cfg.items():
        vals = np.stack([np.atleast_1d(params[e][name]) for e in rows]).astype(np.float64)
        table = pd.DataFrame({"x": np.repeat(ex, vals.shape[1]), "y": np.repeat(ey, vals.shape[1]),
                              "_dim_0": np.tile(np.arange(vals.shape[1]), len(rows)), name: vals.ravel()})
        t0 = time.perf_counter()
        card = smooth_table(table, name, ["x", "y"], ["x", "y"], SmoothingConfig(**cfg))
        seconds["smooth"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = smooth_table(table, name, ["x", "y"], ["x", "y"], SmoothingConfig(**cfg), device="cpu")
        seconds["smooth_cpu"] += time.perf_counter() - t0
        a, b = card[name].to_numpy(), cpu[name].to_numpy()
        check(len(card) == len(table) and np.isfinite(a).all(), f"smooth {name}: {len(card)} of {len(table)} rows finite")
        d_smooth = max(d_smooth, float(np.max(np.abs(a - b) / np.abs(b))))
        # back to [E, ...] rows of expert_locs: NaN where no expert ran
        row_of = {(float(x), float(y)): e for x, y, e in zip(ex, ey, rows)}
        erows = [row_of[(float(x), float(y))] for x, y in card.index.to_frame(index=False).to_numpy()]
        got = np.full((len(experts["x"]), vals.shape[1]), np.nan)
        got[erows, card["_dim_0"].to_numpy()] = a
        loaded[name] = got if name == "lengthscales" else got[:, 0]
    log("post_smooth", points=len(rows), seconds=seconds["smooth"], cpu_seconds=seconds["smooth_cpu"],
        max_rel_card_vs_cpu=d_smooth, bound=SMOOTH_REL_BOUND, config=str(SMOOTH_CONFIG.relative_to(ROOT)))
    check(d_smooth <= SMOOTH_REL_BOUND, f"smoothing, card vs CPU: {d_smooth}")

    # (c) the predict-only re-run from the smoothed fields
    def repredict(cols, locs, load, timers=None, **kw):
        return [r for r in sweep(cols, locs, pred_loc=pred_loc(), optim_kwargs={"max_iter": 100}, optimise=False,
                                 loaded_params=load, timers=timers, **{**OI_KW, **kw}) if not r.get("skipped")]

    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    re_buckets = repredict(obs, experts, loaded, timers["repredict"])
    seconds["repredict"] = time.perf_counter() - t0
    launches_re = {k: fn.launches for k, fn in counters().items()}
    expected = {"block_chol": kernel1_launches(re_buckets, nmax), "panel_chol": 0, "cholesky": 0, "mm3xtf32": 0}
    re_by = by_expert(re_buckets, ("f_mean", "f_var", "num_iter"))
    finite = all(np.isfinite(r["f_mean"]).all() and np.isfinite(r["f_var"]).all() for r in re_buckets)
    pick = np.asarray(sorted(re_by))[:: max(len(re_by) // CPU_TILES, 1)][:CPU_TILES]
    t0 = time.perf_counter()
    cpu = repredict(obs, {c: v[pick] for c, v in experts.items()}, {k: v[pick] for k, v in loaded.items()},
                    dtype=torch.float64, device="cpu", pad_multiple=None)
    seconds["repredict_cpu16"] = time.perf_counter() - t0
    cpu_by = by_expert(cpu, ("f_mean", "f_var"))
    d_re = max(max_abs_pred_diff(re_by[int(e)], cpu_by[j]) for j, e in enumerate(pick))
    log("post_repredict", experts=len(re_by), seconds=seconds["repredict"], phases_s=timers["repredict"], cpu_seconds_16=seconds["repredict_cpu16"],
        prediction_points=int(sum(r["pred_mask"].sum() for r in re_buckets)), finite=finite,
        max_abs_card_f32_vs_cpu_f64=d_re, compared=len(pick), bound=PRED_BOUND, launches=launches_re)
    check(finite, "post re-run: non-finite predictions")
    check(len(re_by) == n and all(re_by[e]["num_iter"] == 0 for e in re_by), "post re-run: experts or iterations")
    check(len(cpu_by) == len(pick) and d_re <= PRED_BOUND, f"post re-run, card f32 vs CPU f64: {d_re}")
    check(launches_re == expected, f"post re-run launches {launches_re}, expected {expected}")

    # (d) the glue of every expert's predictions
    t0 = time.perf_counter()
    preds = preds_frame(re_buckets, experts)
    seconds["preds_table"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    glued = glue_local_predictions(preds, inference_radius=GLUE_RADIUS, R=GLUE_R)
    seconds["glue"] = time.perf_counter() - t0
    keys = ["pred_loc_x", "pred_loc_y"]
    glued = glued.sort_values(keys).reset_index(drop=True)
    span = preds.groupby(keys)["f*"].agg(["min", "max"]).reset_index().sort_values(keys).reset_index(drop=True)
    span = span.astype({"min": np.float64, "max": np.float64})  # the predictions are f32, the glue f64
    n_locs = len(preds[keys].drop_duplicates())
    values = glued[["f*", "f*_var", "y_var", "f_bar"]].to_numpy()
    # a weighted mean of one value may round off it by an ulp
    slack = 1e-12 * np.maximum(span["min"].abs(), span["max"].abs())
    outside = np.maximum(span["min"] - slack - glued["f*"], glued["f*"] - span["max"] - slack).to_numpy()
    inside = bool((outside <= 0).all())
    d_glue = 0.0
    for var in ("f*", "f*_var", "y_var", "f_bar"):
        locs, plain = glue_numpy(preds, GLUE_RADIUS, GLUE_R, var)
        check(np.array_equal(locs, glued[keys].to_numpy()), "glue: locations differ from the plain version's")
        d_glue = max(d_glue, float(np.abs(glued[var].to_numpy() - plain).max() / np.abs(plain).max()))
    log("post_glue", rows=len(preds), locations=len(glued), distinct_locations=n_locs, seconds=seconds["glue"],
        preds_table_seconds=seconds["preds_table"], finite=bool(np.isfinite(values).all()), within_expert_span=inside,
        outside_span={"count": int((outside > 0).sum()), "max": float(outside.max())},
        max_rel_vs_numpy=d_glue, bound=GLUE_REL_BOUND)
    check(len(glued) == n_locs, f"glue: {len(glued)} rows for {n_locs} locations")
    check(np.isfinite(values).all(), "glue: non-finite values")
    check(inside, "glue: a glued f* outside its contributing experts' range")
    check(d_glue <= GLUE_REL_BOUND, f"glue vs plain numpy: {d_glue}")
    log("post", seconds=seconds)

    if profile:
        def workflow():
            bs = fit()
            for name, cfg in smooth_cfg.items():
                vals = np.stack([np.atleast_1d(params[e][name]) for e in rows]).ravel()
                k = len(vals) // len(rows)
                smooth_table(pd.DataFrame({"x": np.repeat(ex, k), "y": np.repeat(ey, k),
                                           "_dim_0": np.tile(np.arange(k), len(rows)), name: vals}),
                             name, ["x", "y"], ["x", "y"], SmoothingConfig(**cfg))
            glue_local_predictions(preds_frame(repredict(obs, experts, loaded), experts), GLUE_RADIUS, GLUE_R)
            return bs

        trace("post", workflow, "profile_post.txt")
    return launches_fit["block_chol"], launches_re["block_chol"]


def make_large_tiles(B, N, P, D, dtype, seed=0, min_fill=0.9):
    """bench_large_n.py's tiles (seed 0, 90-100 % fill), as the port's
    TileBatch; with ``min_fill`` 0.6, bench_models.py's make_batch."""
    from gpsat_tpu_torch.parallel.batching import TileBatch

    rng = np.random.default_rng(seed)
    X = rng.uniform(-6, 6, size=(B, N, D)).astype(dtype)
    y = (np.sin(X[..., 0]) * np.cos(X[..., 1]) + 0.1 * rng.normal(size=(B, N))).astype(dtype)
    mask = np.ones((B, N), dtype=dtype)
    fill = rng.integers(int(min_fill * N), N + 1, size=B)
    for i, f in enumerate(fill):
        mask[i, f:] = 0.0
    Xnew = rng.uniform(-4, 4, size=(B, P, D)).astype(dtype)
    return TileBatch(
        X=X, y=y, mask=mask, Xnew=Xnew,
        pred_mask=np.ones((B, P), dtype=dtype),
        obs_mean=np.zeros(B, dtype=dtype),
        expert_index=np.arange(B),
        num_obs=fill,
    )


def sgpr_core(accum_precision="highest"):
    """bench_large_n.py's core: Matern32, M = 500, softplus bijectors,
    jitter 1e-6, chunk_size "auto", inducing points fixed; the "block" route;
    the chunked loop's products at ``accum_precision``."""
    from gpsat_tpu_torch.models.sgpr import make_sgpr_core

    return make_sgpr_core(kernel="Matern32", num_inducing_points=SGPR_M, accum_precision=accum_precision)


SGPR_MS_PER_ITER = {}  # drive_sgpr's steady seconds per lockstep iteration (ms), by tag


def drive_sgpr(tag, B, n, profile_to=None, accum_precision="highest"):
    """One SGPR bucket at the full width through the engine: a warm-up call,
    then one timed call with the launch counts set to 0 just before it and
    read just after. Returns (batch, core, results, launches by kernel)."""
    import torch

    from gpsat_tpu_torch.models.sgpr import _resolve_chunk
    from gpsat_tpu_torch.parallel.engine import make_batched_runner, run_tile_batch
    from gpsat_tpu_torch.utils.flops import sgpr_iter_flops

    batch = make_large_tiles(B, n, SGPR_P, D, np.float32)
    core = sgpr_core(accum_precision)
    runner = make_batched_runner(core, fixed_params=core.default_fixed_params, **SGPR_RUN_KW)
    init = {"smart_init": True}
    t0 = time.perf_counter()
    run_tile_batch(batch, init, runner, core)
    first_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = run_tile_batch(batch, init, runner, core)
    steady_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}

    conv = int(res["converged"].sum())
    it_max = int(res["num_iter"].max())
    # one evaluation before the loop, one per iteration of the slowest lane,
    # one in the predict; each factors Kuu and B, M identity-padded to a
    # multiple of 64: one launch per 64-block of each. At "high", each chunk
    # of a value and gradient runs W Kuf and A A^T forward, again in the
    # checkpoint's recomputation, and two products in each one's backward
    # (dW, dKuf; dA twice): 8 launches; the predict's chunks 2 each
    C = _resolve_chunk(n, "auto")
    chunks = -(-n // C) if C and n > C else 0
    mm = chunks * (8 * (it_max + 1) + 2) if accum_precision == "high" else 0
    expected = {"block_chol": (it_max + 2) * 2 * (-(-SGPR_M // T)), "panel_chol": 0, "cholesky": 0, "mm3xtf32": mm}
    tflops = B * it_max * sgpr_iter_flops(n, SGPR_M, D) / steady_s / 1e12
    SGPR_MS_PER_ITER[tag] = steady_s * 1e3 / max(it_max, 1)
    log(f"sgpr_{tag}", core=core.name, accum_precision=accum_precision, B=B, N=n, M=SGPR_M, chunk=C,
        experts_per_s=B / steady_s, points_per_s=B * n / steady_s, steady_s=steady_s, first_call_s=first_s,
        ms_per_iteration=SGPR_MS_PER_ITER[tag],
        achieved_tflops=tflops, share_of_f32_peak=tflops * 1e12 / F32_FLOPS_PER_S, converged=conv,
        stall_exits=int(res["stalled"].sum()), failed_exits=int(res["failed"].sum()),
        iters_mean=float(res["num_iter"].mean()), iters_max=it_max,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches, launches_predicted=expected)
    check(np.isfinite(res["f_mean"]).all() and np.isfinite(res["f_var"]).all(), f"sgpr {tag}: non-finite predictions")
    check(conv >= MIN_SHARE * B, f"sgpr {tag}: only {conv}/{B} lanes converged")
    check(launches["block_chol"] > 0 and launches == expected, f"sgpr {tag} launches {launches}, expected {expected}")
    if profile_to:
        trace(f"sgpr_{tag}", lambda: run_tile_batch(batch, init, runner, core), profile_to)
    return batch, core, res, launches


def phase_sgpr_accuracy(batch, core, res, tag="sgpr_accuracy", small=True):
    """(c): (a)'s first tiles in f64 on the card (library arm), (a)'s f32
    optima polished in f64 on the card, and (``small``) 2 tiles of N=1,024
    in f64 on the card against the CPU. The same checks hold (b)'s fit at
    accum_precision "high" (``tag`` "sgpr_high_accuracy")."""
    from gpsat_tpu_torch.parallel.batching import cast_batch, take_batch
    from gpsat_tpu_torch.parallel.engine import make_batched_runner, polish_tile_batch, run_tile_batch

    idx = np.arange(SGPR_F64_TILES)
    runner64 = make_batched_runner(core, fixed_params=core.default_fixed_params, **SGPR_F64_KW)
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    # the first tiles draw the same inducing points as in the whole batch
    f64 = run_tile_batch(cast_batch(take_batch(batch, idx), np.float64), {"smart_init": True}, runner64, core)
    f64_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    check(not any(launches.values()), f"sgpr f64 on the card launched a kernel: {launches}")
    raw = max_abs_pred_diff({k: res[k][idx] for k in ("f_mean", "f_var")}, f64)
    t0 = time.perf_counter()
    pol = polish_tile_batch(batch, res, core, max_iter=150)
    polish_s = time.perf_counter() - t0
    agree = np.abs(pol["objective"][idx] - f64["objective"]) <= WORSE_OPTIMUM_NATS
    d_pol = max((max_abs_pred_diff(pol, f64, [i]) for i in idx[agree]), default=float("inf"))
    check(np.array_equal(pol["inducing_points"], res["inducing_points"]), "sgpr polish moved the fixed inducing points")
    row = dict(tiles=SGPR_F64_TILES, f64_card_s=f64_s, f64_converged=int(f64["converged"].sum()),
               f64_iters_max=int(f64["num_iter"].max()), raw_f32_vs_f64=raw, raw_bound=SGPR_RAW_BOUND,
               objective_f32_minus_f64=(res["objective"][idx] - f64["objective"]).tolist(),
               polish_s=polish_s, polish_converged=int(pol["converged"].sum()), polish_lanes=len(pol["converged"]),
               polish_iters_mean=float(pol["num_iter"].mean()), polish_iters_max=int(pol["num_iter"].max()),
               polish_failed=int(pol["failed"].sum()), polished_vs_f64=d_pol, polished_compared=int(agree.sum()),
               polish_bound=F64_BOUND)
    fits = [f64, pol]
    if small:
        tiles = make_large_tiles(*SGPR_SMALL, SGPR_P, D, np.float64)
        t0 = time.perf_counter()
        card = run_tile_batch(tiles, {"smart_init": True}, runner64, core)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = run_tile_batch(tiles, {"smart_init": True},
                             make_batched_runner(core, fixed_params=core.default_fixed_params, device="cpu",
                                                 **SGPR_F64_KW),
                             core, device="cpu")
        cpu_s = time.perf_counter() - t0
        fits += [card, cpu]
        row.update(small_tiles=list(SGPR_SMALL), small_card_s=card_s, small_cpu_s=cpu_s,
                   small_card_vs_cpu=max_abs_pred_diff(card, cpu), small_bound=F64_BOUND,
                   small_iters=[int(card["num_iter"].max()), int(cpu["num_iter"].max())])
    log(tag, **row)
    check(all(np.isfinite(r["f_mean"]).all() and np.isfinite(r["f_var"]).all() for r in fits),
          f"{tag}: non-finite predictions")
    check(raw <= SGPR_RAW_BOUND, f"{tag}: raw f32 vs f64 on the card: {raw}")
    check(agree.sum() >= MIN_COMPARED_SHARE * len(idx), f"{tag} polish: objectives agree on {int(agree.sum())}/{len(idx)}")
    check(d_pol <= F64_BOUND, f"{tag}: polished vs the f64 fit: {d_pol}")
    if small:
        check(row["small_card_vs_cpu"] <= F64_BOUND, f"sgpr f64, card vs CPU at N={SGPR_SMALL[1]}: "
                                                     f"{row['small_card_vs_cpu']}")


def phase_sgpr_pair(batch, core):
    """(d): the factor pair of a Kuu from (a)'s first evaluation (the
    engine's init: smart_init, the drawn inducing points), on the kernel
    against the same function on the plain version, and the gradient of a
    scalar of (L, W) through the pair against f64 autograd through
    torch.linalg.cholesky and torch.linalg.inv."""
    import torch

    from gpsat_tpu_torch.ops import block_chol as BC
    from gpsat_tpu_torch.ops import kernels as K
    from gpsat_tpu_torch.ops import linalg as LA
    from gpsat_tpu_torch.parallel.engine import _smart_init, resolve_device

    init = core.prepare_batch_init(batch, _smart_init(batch))
    dev = resolve_device()
    Z, ls, kv = (torch.as_tensor(np.asarray(init[k]), device=dev)
                 for k in ("inducing_points", "lengthscales", "kernel_variance"))
    Kuu = LA.add_diag(K.gram("Matern32", Z, Z, ls, kv), 1e-6)
    M, P = Kuu.shape[-1], -(-Kuu.shape[-1] // T) * T
    eye64 = torch.eye(M, dtype=torch.float64, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    G1, G2 = (torch.randn(Kuu.shape, generator=g, device=dev) for _ in range(2))

    def plain_pair(K32):
        Kp = torch.eye(P, device=dev).repeat(K32.shape[0], 1, 1)
        Kp[:, :M, :M] = K32
        L, Wd = LA._blocked_cholesky(Kp, T, BC.factor_blocks_reference)
        return L[:, :M, :M], LA.tri_inv_from_diag(L, torch.stack(Wd, dim=1), T)[:, :M, :M]

    def scalar(L, W):
        return (torch.tril(L) * G1.to(L.dtype)).sum() + (torch.tril(W) * G2.to(L.dtype)).sum()

    def grad_of(K32, fn):
        K = K32.clone().requires_grad_(True)
        scalar(*fn(K)).backward()
        return K.grad

    out = {}
    for case, K32 in (("kuu", Kuu), ("kuu_plus_1e-2kv", LA.add_diag(Kuu, GRAD_SHIFT * kv))):
        before = BC.factor_blocks.launches
        L, W = LA.chol_winv_padded(K32)
        torch.cuda.synchronize()
        check(BC.factor_blocks.launches == before + P // T, f"pair {case}: the kernel did not launch {P // T} times")
        Lr, Wr = plain_pair(K32)
        K64 = K32.double()
        ev = torch.linalg.eigvalsh(K64)
        ref = grad_of(K64, lambda K: (lambda L: (L, torch.linalg.inv(L)))(torch.linalg.cholesky(K)))
        gk = grad_of(K32, LA.chol_winv_padded)
        glib = grad_of(K32, lambda K: (lambda L: (L, torch.linalg.inv(L)))(torch.linalg.cholesky(K)))
        scale = float(ref.abs().max())
        row = {
            "cond_max": float((ev[:, -1] / ev[:, 0]).max()),
            "rel_dL": float((L - Lr).abs().max() / Lr.abs().max()),
            "rel_dW": float((W - Wr).abs().max() / Wr.abs().max()),
            "LLt_minus_K": float((torch.matmul(L, L.transpose(1, 2)) - K32).abs().max()),
            "LW_minus_I": float((torch.matmul(L.double(), W.double()) - eye64).abs().max()),
            "grad_rel_err_pair": float((gk.double() - ref).abs().max()) / scale,
            "grad_rel_err_library_f32": float((glib.double() - ref).abs().max()) / scale,
            "grad_finite": bool(torch.isfinite(gk).all()),
        }
        out[case] = row
        check(row["rel_dL"] <= PAIR_REL_BOUND["L"] and row["rel_dW"] <= PAIR_REL_BOUND["W"],
              f"pair {case}, kernel vs plain: {row}")
        check(row["LLt_minus_K"] <= PAIR_BACKWARD_BOUND["LLt"] and row["LW_minus_I"] <= PAIR_BACKWARD_BOUND["LW"],
              f"pair {case}, backward errors: {row}")
        check(row["grad_finite"], f"pair {case}: non-finite gradient")
    check(out["kuu"]["grad_rel_err_pair"] <= GRAD_VS_LIBRARY * out["kuu"]["grad_rel_err_library_f32"],
          f"pair gradient on Kuu: {out['kuu']}")
    check(out["kuu_plus_1e-2kv"]["grad_rel_err_pair"] <= GRAD_CONDITIONED_BOUND,
          f"pair gradient on the conditioned Kuu: {out['kuu_plus_1e-2kv']}")
    log("sgpr_pair", shape=list(Kuu.shape), pair_bounds=PAIR_REL_BOUND, backward_bounds=PAIR_BACKWARD_BOUND,
        grad_vs_library=GRAD_VS_LIBRARY, grad_conditioned_bound=GRAD_CONDITIONED_BOUND, **out)


def phase_replace():
    """(e): phase 7's geometry through the sweep with SGPR (M = 64) as the
    main model and exact GPR as the replacement below 64 observations; each
    lane against a sweep of its experts alone with its model. Launch counts
    are set to 0 just before each sweep and read just after it. Returns
    kernel 1's launches of the two-lane sweep."""
    import torch

    from gpsat_tpu_torch.data.prediction_locations import PredictionLocations
    from gpsat_tpu_torch.experts import sweep

    obs, experts, grid = pipeline_inputs()
    kw = {**OI_KW, "init_params": {**OI_KW["init_params"], "num_inducing_points": REPLACE_M}}

    def run(locs, **extra):
        torch.cuda.synchronize()
        for fn in counters().values():
            fn.launches = 0
        t0 = time.perf_counter()
        pred_loc = PredictionLocations("from_dataframe", coords_col=["x", "y"], df=grid, max_dist=OI_MAX_DIST)
        out = [r for r in sweep(obs, locs, pred_loc=pred_loc, optim_kwargs=REPLACE_OPTIM, **{**kw, **extra})
               if not r.get("skipped")]
        return out, time.perf_counter() - t0, {k: fn.launches for k, fn in counters().items()}

    def expected(buckets):
        # SGPR: two pairs of 64 per evaluation; GPR: one pair of Nmax = 128
        return {"block_chol": sum((int(r["num_iter"].max()) + 2) * 2 for r in buckets), "panel_chol": 0,
                "cholesky": 0, "mm3xtf32": 0}

    both, wall_s, launches = run(experts, model="GPflowSGPRModel", replacement_threshold=REPLACE_THRESHOLD,
                                 replacement_model="GPflowGPRModel", replacement_optim_kwargs=REPLACE_OPTIM)
    lanes = {}
    for r in both:
        lanes.setdefault(r["lane"], []).append(r)
    check(sorted(lanes) == ["main", "replacement"], f"replace: lanes {sorted(lanes)}")
    rows = {}
    for lane, model, ok in (("main", "GPflowSGPRModel", lambda n: n >= REPLACE_THRESHOLD),
                            ("replacement", "GPflowGPRModel", lambda n: n < REPLACE_THRESHOLD)):
        got = by_expert(lanes[lane], ("f_mean", "f_var", "num_obs", "converged"))
        check(all(ok(int(v["num_obs"])) for v in got.values()), f"replace: an expert in the {lane} lane by mistake")
        sub = np.asarray(sorted(got))
        alone, alone_s, alone_launches = run({c: v[sub] for c, v in experts.items()}, model=model)
        ref = by_expert(alone, ("f_mean", "f_var"))
        d = max(max_abs_pred_diff(got[int(e)], ref[j]) for j, e in enumerate(sub))
        rows[lane] = {"model": model, "experts": len(sub), "converged": int(sum(v["converged"] for v in got.values())),
                      "iters_max": int(max(r["num_iter"].max() for r in lanes[lane])), "alone_s": alone_s,
                      "max_abs_vs_alone": d, "launches_alone": alone_launches,
                      "launches_alone_predicted": expected(alone)}
        check(len(ref) == len(sub) and d <= REPLACE_BOUND, f"replace: {lane} lane vs its experts alone: {d}")
        check(alone_launches["block_chol"] > 0 and alone_launches == expected(alone),
              f"replace: {lane} lane alone launches {alone_launches}, expected {expected(alone)}")
        check(rows[lane]["converged"] >= MIN_SHARE * len(sub), f"replace: {lane} lane converged {rows[lane]}")
    log("sgpr_replace", threshold=REPLACE_THRESHOLD, M=REPLACE_M, wall_s=wall_s,
        experts=sum(v["experts"] for v in rows.values()), lanes=rows, launches=launches,
        launches_predicted=expected(both), bound=REPLACE_BOUND)
    check(launches == expected(both), f"replace launches {launches}, expected {expected(both)}")
    return launches["block_chol"]


def phase_sgpr_full_high(batch, res):
    """(a) at accum_precision "high": the unchunked bound never reaches the
    relaxed products (the JAX core relaxes its chunked loop only), so the
    fit is (a)'s bit for bit and the 3xTF32 kernel launches no time."""
    import torch

    from gpsat_tpu_torch.parallel.engine import make_batched_runner, run_tile_batch

    core = sgpr_core("high")
    runner = make_batched_runner(core, fixed_params=core.default_fixed_params, **SGPR_RUN_KW)
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    high = run_tile_batch(batch, {"smart_init": True}, runner, core)
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    same = all(np.array_equal(high[k], res[k]) for k in ("f_mean", "f_var", "objective", "num_iter"))
    log("sgpr_full_high", accum_precision="high", seconds=seconds, bit_identical_to_highest=same, launches=launches)
    check(same, "sgpr (a) at accum_precision 'high' differs from 'highest'")
    check(launches["mm3xtf32"] == 0, f"sgpr (a) at 'high' launched the 3xTF32 kernel: {launches}")


def phase_sgpr(profile: bool):
    """Phase 9. Returns kernel 1's launches in (a), (b), (b) at "high" and
    (e), and the 3xTF32 kernel's in (b) at "high"."""
    batch, core, res, launches_a = drive_sgpr("full", *SGPR_FULL, "profile_sgpr.txt" if profile else None)
    phase_sgpr_full_high(batch, res)
    _, _, _, launches_b = drive_sgpr("chunked", *SGPR_CHUNKED)
    hbatch, hcore, hres, launches_bh = drive_sgpr("chunked_high", *SGPR_CHUNKED, accum_precision="high")
    check(launches_bh["mm3xtf32"] > 0, "sgpr (b) at 'high' never launched the 3xTF32 kernel")
    log("sgpr_chunked_levels", ms_per_iteration_highest=SGPR_MS_PER_ITER["chunked"],
        ms_per_iteration_high=SGPR_MS_PER_ITER["chunked_high"])
    phase_sgpr_accuracy(batch, core, res)
    phase_sgpr_accuracy(hbatch, sgpr_core("highest"), hres, tag="sgpr_high_accuracy", small=False)
    phase_sgpr_pair(batch, core)
    return (launches_a["block_chol"], launches_b["block_chol"], launches_bh["block_chol"], phase_replace(),
            launches_bh["mm3xtf32"])


def svgp_runner(core, device=None, **kw):
    """The runner the orchestrator builds for ``core``: Adam for an Adam
    core, L-BFGS (the dtype's default search) otherwise."""
    from gpsat_tpu_torch.parallel.engine import make_runner_for

    return make_runner_for(core, fixed_params=core.default_fixed_params, device=device, **kw)


def drive_svgp(tag, core, batch, run_kw, expected, flops_per_iter, profile_to=None, trace_max_iter=None):
    """One SVGP path at the full width: a short warm-up call (3 iterations),
    then one timed call with every launch count set to 0 just before it and
    read just after. ``expected(it_max)`` is kernel 1's launch count, derived
    from the code. With ``profile_to`` one more call is traced, cut to
    ``trace_max_iter`` iterations if given (a 2,000-iteration trace is too
    large to tabulate). Returns (results, launches)."""
    import torch

    from gpsat_tpu_torch.parallel.engine import run_tile_batch

    init = {"smart_init": True}
    t0 = time.perf_counter()
    run_tile_batch(batch, init, svgp_runner(core, **{**run_kw, "max_iter": 3}), core)
    first_s = time.perf_counter() - t0
    runner = svgp_runner(core, **run_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = run_tile_batch(batch, init, runner, core)
    steady_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    Bn = batch.B
    conv, it_max = int(res["converged"].sum()), int(res["num_iter"].max())
    want = {"block_chol": expected(it_max), "panel_chol": 0, "cholesky": 0, "mm3xtf32": 0}
    tflops = Bn * it_max * flops_per_iter / steady_s / 1e12
    log(f"svgp_{tag}", core=core.name, B=Bn, N=batch.X.shape[1], M=SVGP_M, experts_per_s=Bn / steady_s,
        steady_s=steady_s, warmup_3_iter_s=first_s, converged=conv, stall_exits=int(res["stalled"].sum()),
        failed_exits=int(res["failed"].sum()), iters_mean=float(res["num_iter"].mean()), iters_max=it_max,
        achieved_tflops=tflops, share_of_f32_peak=tflops * 1e12 / F32_FLOPS_PER_S,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches, launches_predicted=want)
    check(np.isfinite(res["f_mean"]).all() and np.isfinite(res["f_var"]).all(), f"svgp {tag}: non-finite predictions")
    check(conv >= MIN_SHARE * Bn, f"svgp {tag}: only {conv}/{Bn} lanes converged")
    check(launches["block_chol"] > 0 and launches == want, f"svgp {tag} launches {launches}, expected {want}")
    if profile_to:
        traced = svgp_runner(core, **{**run_kw, "max_iter": trace_max_iter}) if trace_max_iter else runner
        trace(f"svgp_{tag}", lambda: run_tile_batch(batch, init, traced, core), profile_to)
    return res, launches["block_chol"]


def svgp_f64_reference(tag, core, batch, res):
    """The first SVGP_F64_TILES tiles fitted in f64 on the card with the
    dtype's default search (zoom; the library arm, no kernel launch);
    returns (f64 result, max |f32 - f64| over f_mean and f_var)."""
    from gpsat_tpu_torch.parallel.batching import cast_batch, take_batch
    from gpsat_tpu_torch.parallel.engine import run_tile_batch

    idx = np.arange(SVGP_F64_TILES)
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    # the first tiles draw the same inducing points as in the whole batch
    f64 = run_tile_batch(cast_batch(take_batch(batch, idx), np.float64), {"smart_init": True},
                         svgp_runner(core, max_iter=SVGP_F64_MAX_ITER), core)
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    check(not any(launches.values()), f"svgp {tag} f64 on the card launched a kernel: {launches}")
    check(np.isfinite(f64["f_mean"]).all() and np.isfinite(f64["f_var"]).all(), f"svgp {tag} f64: non-finite")
    d = max_abs_pred_diff({k: res[k][idx] for k in ("f_mean", "f_var")}, f64)
    log(f"svgp_{tag}_f64", tiles=len(idx), seconds=seconds, converged=int(f64["converged"].sum()),
        iters=f64["num_iter"].tolist(), objective_f32_minus_f64=(res["objective"][idx] - f64["objective"]).tolist(),
        f32_vs_f64=d)
    return f64, d


def svgp_bound_at(batch, res, i, kw):
    """The negative collapsed bound of (a)'s lane ``i`` at the parameters it
    ended with (its last iterate), on the card through the "block" route
    (kernel 1 in f32; its library arm in f64) and the "cholesky" route (the
    library), in f32 and in f64; each f32 value's error against the f64
    library value."""
    import torch

    from gpsat_tpu_torch.models.sgpr import elbo
    from gpsat_tpu_torch.parallel.engine import resolve_device

    dev = resolve_device(None)
    names = ("lengthscales", "kernel_variance", "likelihood_variance", "inducing_points")
    out = {}
    for tag, dt in (("f32", torch.float32), ("f64", torch.float64)):
        data = {k: torch.as_tensor(np.asarray(getattr(batch, k)[[i]]), dtype=dt, device=dev)
                for k in ("X", "y", "mask")}
        cp = {k: torch.as_tensor(np.asarray(res[k][[i]]), dtype=dt, device=dev) for k in names}
        for route in ("block", "cholesky"):
            with torch.no_grad():
                out[f"{tag}_{route}"] = -float(elbo(cp, data, kernel=kw["kernel"], jitter=kw["jitter"],
                                                    factor=route)[0])
    ref = out["f64_cholesky"]
    out.update({f"{k}_minus_f64_library": v - ref for k, v in list(out.items()) if k.startswith("f32")})
    out["reported_objective_minus_f64_library"] = float(res["objective"][i]) - ref
    return out


def svgp_failed_lanes(batch, res, kw):
    """(a)'s lanes that exited ``failed``: their index, iterations and last
    objective, the bound at their last iterate on both routes in f32 and f64
    (``svgp_bound_at``), and each re-run alone on the card through the
    "cholesky" route (the library: a 64-wide Kuu is outside kernel 3's
    domain) in f32 and in f64, with the collapsed bound (the SGPR core's)
    and the lane's own inducing points. A diagnostic: it prints, and fails
    nothing."""
    from gpsat_tpu_torch.models.sgpr import make_sgpr_core
    from gpsat_tpu_torch.parallel.batching import cast_batch, take_batch
    from gpsat_tpu_torch.parallel.engine import make_batched_runner, run_tile_batch

    idx = np.flatnonzero(res["failed"])
    lanes = {int(i): {"num_iter": int(res["num_iter"][i]), "objective": float(res["objective"][i]),
                      "bound_at_last_iterate": svgp_bound_at(batch, res, i, kw)} for i in idx}
    reruns = {}
    if len(idx):
        core = make_sgpr_core(factor="cholesky", **kw)
        init = {"smart_init": True, "inducing_points": res["inducing_points"][idx]}
        for name, dt in (("f32", np.float32), ("f64", np.float64)):
            sub = cast_batch(take_batch(batch, idx), dt)
            runner = make_batched_runner(core, fixed_params=core.default_fixed_params,
                                         max_iter=SVGP_MAX_ITER["collapsed"])
            r = run_tile_batch(sub, init, runner, core)
            reruns[name] = {"num_iter": r["num_iter"].tolist(), "objective": r["objective"].tolist(),
                            "converged": r["converged"].tolist(), "failed": r["failed"].tolist(),
                            "stalled": r["stalled"].tolist()}
    log("svgp_collapsed_failed_lanes", lanes=lanes, library_route=reruns)


def phase_svgp_linesearch():
    """(d): an f64 GPR fit (B=16, N=128) with zoom and with backtracking on
    the card (library arm, no kernel) against the same fit on the CPU, and
    against the single-eval f64 optimum of the same tiles."""
    from gpsat_tpu_torch.models.functional import make_gpr_core
    from gpsat_tpu_torch.parallel.engine import make_batched_runner, run_tile_batch

    batch = make_large_tiles(LS_B, LS_N, SVGP_P, D, np.float64, min_fill=0.6)
    core = make_gpr_core(jitter=1e-5)
    init = {"smart_init": True}
    ref = run_tile_batch(batch, init, make_batched_runner(core, max_iter=1000, **CPU_F64_KW), core)
    rows = {}
    for ls in ("zoom", "backtracking"):
        for fn in counters().values():
            fn.launches = 0
        t0 = time.perf_counter()
        card = run_tile_batch(batch, init, make_batched_runner(core, max_iter=1000, linesearch=ls), core)
        card_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters().items()}
        t0 = time.perf_counter()
        cpu = run_tile_batch(batch, init, make_batched_runner(core, max_iter=1000, linesearch=ls, device="cpu"), core,
                             device="cpu")
        cpu_s = time.perf_counter() - t0
        rows[ls] = {"card_s": card_s, "cpu_s": cpu_s, "converged": [int(card["converged"].sum()),
                                                                   int(cpu["converged"].sum())],
                    "iters_max": [int(card["num_iter"].max()), int(cpu["num_iter"].max())],
                    "same_num_iter": int((card["num_iter"] == cpu["num_iter"]).sum()),
                    "card_vs_cpu": max_abs_pred_diff(card, cpu), "card_vs_single_eval": max_abs_pred_diff(card, ref),
                    "launches": launches}
        check(not any(launches.values()), f"{ls} f64 on the card launched a kernel: {launches}")
        check(card["converged"].all() and cpu["converged"].all(), f"{ls}: unconverged lanes {rows[ls]}")
    log("svgp_linesearch", B=LS_B, N=LS_N, card_bound=LS_CARD_BOUND, optimum_bound=F64_BOUND,
        single_eval_iters_max=int(ref["num_iter"].max()), **rows)
    for ls, row in rows.items():
        check(row["card_vs_cpu"] <= LS_CARD_BOUND, f"{ls}: card vs CPU {row['card_vs_cpu']}")
        check(row["card_vs_single_eval"] <= F64_BOUND, f"{ls}: vs the single-eval optimum {row['card_vs_single_eval']}")


def phase_svgp_config():
    """(e): the model block of configs/example_local_expert_oi_svgp.json
    (M = 64, Gaussian, the collapsed solver, max_iter 2000) through the
    sweep at phase 7's geometry, f32 on the card; 16 experts against a CPU
    f64 sweep of the same experts with the single-eval search (the f64
    references of phases 4 and 7; (d) holds it to zoom's optimum within
    1e-5). Returns kernel 1's launches."""
    import torch

    from gpsat_tpu_torch.data.prediction_locations import PredictionLocations
    from gpsat_tpu_torch.experts import sweep

    model = json.loads(SVGP_CONFIG.read_text())["model"]
    obs, experts, grid = pipeline_inputs()
    kw = {**OI_KW, "model": model["oi_model"], "init_params": model["init_params"],
          "constraints": model["constraints"], "optim_kwargs": model["optim_kwargs"]}

    def run(locs, **extra):
        pred_loc = PredictionLocations("from_dataframe", coords_col=["x", "y"], df=grid, max_dist=OI_MAX_DIST)
        return [r for r in sweep(obs, locs, pred_loc=pred_loc, **{**kw, **extra}) if not r.get("skipped")]

    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = run(experts)
    wall_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    # per bucket: (it_max + 1) evaluations of the collapsed bound (two pairs
    # each), the closed-form q (two pairs), the predict (one pair)
    want = {"block_chol": sum(2 * int(r["num_iter"].max()) + 5 for r in out), "panel_chol": 0, "cholesky": 0, "mm3xtf32": 0}
    got = by_expert(out, ("f_mean", "f_var", "converged", "objective", "num_iter", "inducing_points"))
    n = len(got)
    conv = int(sum(v["converged"] for v in got.values()))
    pick = np.sort(np.asarray(sorted(got)))[:: max(n // CPU_TILES, 1)][:CPU_TILES]
    # the inducing points are drawn per bucket in tile order: the reference
    # loads each expert's own
    Z = {"inducing_points": np.stack([got[int(e)]["inducing_points"] for e in pick]).astype(np.float64)}
    t0 = time.perf_counter()
    cpu = by_expert(run({c: v[pick] for c, v in experts.items()}, dtype=torch.float64, device="cpu", loaded_params=Z,
                        optim_kwargs={**model["optim_kwargs"], "linesearch": "single_eval"}),
                    ("f_mean", "f_var", "objective", "converged"))
    cpu_s = time.perf_counter() - t0
    # compare the experts whose two fits stopped on the same optimum: against
    # a zoom reference 2 of 16 small tiles stopped on different stationary
    # points (objectives 0.94 and 4.4 nats apart, lengthscales at their
    # bound on one side; tools/rehearse_chip_smoke.py), against the
    # single-eval one none did
    same = {j: abs(cpu[j]["objective"] - got[int(e)]["objective"]) <= SVGP_SAME_OPTIMUM_NATS
            for j, e in enumerate(pick)}
    d = [max_abs_pred_diff(got[int(e)], cpu[j]) for j, e in enumerate(pick) if same[j]]
    log("svgp_config", config=str(SVGP_CONFIG.relative_to(ROOT)), experts=n, buckets=len(out), wall_s=wall_s,
        experts_per_s=n / wall_s, converged=conv, converged_share=conv / n,
        iters_mean=float(np.mean([v["num_iter"] for v in got.values()])),
        iters_max=int(max(v["num_iter"] for v in got.values())), launches=launches, launches_predicted=want,
        compared=len(d), other_optimum={int(e): [float(got[int(e)]["objective"]), float(cpu[j]["objective"])]
                                        for j, e in enumerate(pick) if not same[j]},
        f32_vs_cpu_f64=max(d) if d else None, bound=PRED_BOUND, cpu_f64_s=cpu_s,
        cpu_converged=int(sum(v["converged"] for v in cpu.values())))
    check(all(np.isfinite(v["f_mean"]).all() and np.isfinite(v["f_var"]).all() for v in got.values()),
          "svgp config: non-finite predictions")
    check(conv >= MIN_SHARE * n, f"svgp config: only {conv}/{n} experts converged")
    check(launches["block_chol"] > 0 and launches == want, f"svgp config launches {launches}, expected {want}")
    check(len(d) >= MIN_COMPARED_SHARE * len(pick), f"svgp config: {len(d)}/{len(pick)} experts compared")
    check(max(d) <= PRED_BOUND, f"svgp config: card f32 vs CPU f64 {max(d)}")
    return launches["block_chol"]


def phase_svgp(profile: bool):
    """Phase 10. Returns kernel 1's launches in (a), (b), (c) and (e)."""
    from gpsat_tpu_torch.models.svgp import make_svgp_core
    from gpsat_tpu_torch.utils.flops import sgpr_iter_flops, svgp_iter_flops

    batch = make_large_tiles(SVGP_B, SVGP_N, SVGP_P, D, np.float32, min_fill=0.6)
    kw = dict(kernel="Matern32", jitter=SVGP_JITTER, num_inducing_points=SVGP_M)

    # (a) the collapsed bound: (it_max + 1) evaluations of two pairs (Kuu and
    # B), finalize_params' closed-form q (two pairs), the predict (one pair)
    col = make_svgp_core(**kw)
    res_a, la = drive_svgp("collapsed", col, batch, {"max_iter": SVGP_MAX_ITER["collapsed"]},
                           lambda it: 2 * (it + 1) + 2 + 1, sgpr_iter_flops(SVGP_N, SVGP_M, D),
                           "profile_svgp_collapsed.txt" if profile else None)
    _, d_a = svgp_f64_reference("collapsed", col, batch, res_a)
    check(d_a <= PRED_BOUND, f"svgp collapsed: f32 vs f64 {d_a}")
    svgp_failed_lanes(batch, res_a, kw)

    # (b) Bernoulli, joint L-BFGS: device_init's collapsed q (two pairs),
    # (it_max + 1) ELBO evaluations (one pair), the predict (one pair)
    bern = make_svgp_core(likelihood="Bernoulli", **kw)
    labels = batch.__class__(**{**batch.__dict__, "y": (batch.y > 0).astype(np.float32)})
    res_b, lb = drive_svgp("bernoulli", bern, labels, {"max_iter": SVGP_MAX_ITER["bernoulli"]},
                           lambda it: 2 + (it + 1) + 1, svgp_iter_flops(SVGP_N, SVGP_M, D))
    _, d_b = svgp_f64_reference("bernoulli", bern, labels, res_b)
    check(d_b <= SVGP_BERNOULLI_BOUND, f"svgp bernoulli: f32 vs f64 {d_b}")

    # (c) Adam + natural gradients: device_init's collapsed q (two pairs),
    # two ELBO evaluations per iteration (the natural-gradient step and
    # Adam's), the final objective and the predict (one pair each)
    nat = make_svgp_core(natural_gradients=True, gamma=0.5, **kw)
    res_c, lc = drive_svgp("adam_natgrad", nat, batch, SVGP_ADAM_KW, lambda it: 2 + 2 * it + 1 + 1,
                           2 * svgp_iter_flops(SVGP_N, SVGP_M, D),
                           "profile_svgp_adam.txt" if profile else None, trace_max_iter=200)
    gap = res_c["objective"] - res_a["objective"]
    log("svgp_adam_vs_collapsed", neg_elbo_gap_min=float(gap.min()), neg_elbo_gap_max=float(gap.max()),
        neg_elbo_gap_mean=float(gap.mean()), above_bound=SVGP_ELBO_ABOVE, below_bound=SVGP_ELBO_BELOW)
    check(gap.max() <= SVGP_ELBO_ABOVE and gap.min() >= -SVGP_ELBO_BELOW,
          f"svgp adam + natgrad vs collapsed: -ELBO gap in [{gap.min()}, {gap.max()}]")

    phase_svgp_linesearch()
    return la, lb, lc, phase_svgp_config()


def zoo_model_block(tag):
    """(model name, init_params, constraints, optim_kwargs) of phase 11's
    lane ``tag``: the VFF config's model block, or for "asvgp" the same
    block with GPflowASVGPModel and its own defaults."""
    model = json.loads(VFF_CONFIG.read_text())["model"]
    ip = dict(model["init_params"])
    if tag == "vff":
        return model["oi_model"], ip, model["constraints"], dict(model["optim_kwargs"])
    ip = {k: v for k, v in ip.items() if k not in ZOO_ASVGP_DROP}
    return "GPflowASVGPModel", ip, model["constraints"], dict(model["optim_kwargs"])


def zoo_lane(tag, profile: bool):
    """One inter-domain lane of phase 11 through the sweep at phase 7's
    geometry, f32 on the card: kernel 1 in P's factor pair of every
    evaluation and of the predict, its launches held to a formula; then 16
    experts' tiles fitted in f64 from their f32 optima on the CPU, and the
    bound and predictions at that fit's parameters in f64 on the card (the
    library arm, no launch) against the CPU's within 1e-8. Returns kernel
    1's launches."""
    import torch

    from gpsat_tpu_torch.data import select as sel
    from gpsat_tpu_torch.data.prediction_locations import PredictionLocations
    from gpsat_tpu_torch.experts import core_for, sweep
    from gpsat_tpu_torch.models import get_model
    from gpsat_tpu_torch.parallel import batching
    from gpsat_tpu_torch.parallel.engine import make_batched_runner, run_tile_batch
    from gpsat_tpu_torch.utils.flops import collapsed_kron_elbo_flops

    name, ip, cons, optim = zoo_model_block(tag)
    obs, experts, grid = pipeline_inputs()
    kw = {**OI_KW, "model": name, "init_params": ip, "constraints": cons,
          "optim_kwargs": {**optim, "max_iter": ZOO_MAX_ITER}}
    core = core_for(ip, cons, model_cls=get_model(name))
    mtot = core.num_features(D)
    width = batching.round_up(mtot, T)

    def run(locs):
        pred_loc = PredictionLocations("from_dataframe", coords_col=["x", "y"], df=grid, max_dist=OI_MAX_DIST)
        return [r for r in sweep(obs, locs, pred_loc=pred_loc, **kw) if not r.get("skipped")]

    def launches_now():
        return {k: fn.launches for k, fn in counters().items()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = run(experts)
    wall_s = time.perf_counter() - t0
    launches = launches_now()
    # per bucket: one factor pair of P per evaluation (the initial one, one
    # per iteration of the slowest lane) and one in the predict, W/64
    # launches each (W: the feature count identity-padded to 64)
    want = {"block_chol": sum(int(r["num_iter"].max()) + 2 for r in out) * (width // T), "panel_chol": 0,
            "cholesky": 0, "mm3xtf32": 0}
    keep = ("f_mean", "f_var", "converged", "stalled", "failed", "objective", "num_iter", "num_obs",
            *core.param_names)
    got = by_expert(out, keep)
    n = len(got)
    conv = int(sum(v["converged"] for v in got.values()))
    model_flops = sum((v["num_iter"] + 1) * 3.0 * collapsed_kron_elbo_flops(int(v["num_obs"]), mtot)
                      for v in got.values())
    log(f"zoo_{tag}", model=name, core=core.name, features=mtot, padded_width=width, experts=n, buckets=len(out),
        bucket_experts=[len(r["expert_index"]) for r in out], nmax_obs=int(max(v["num_obs"] for v in got.values())),
        wall_s=wall_s, experts_per_s=n / wall_s,
        converged=conv, converged_share=conv / n, stall_exits=int(sum(v["stalled"] for v in got.values())),
        failed_exits=int(sum(v["failed"] for v in got.values())),
        iters_mean=float(np.mean([v["num_iter"] for v in got.values()])),
        iters_max=int(max(v["num_iter"] for v in got.values())), model_tflops=model_flops / wall_s / 1e12,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches, launches_predicted=want)
    check(all(np.isfinite(v["f_mean"]).all() and np.isfinite(v["f_var"]).all() for v in got.values()),
          f"zoo {tag}: non-finite predictions")
    check(conv >= MIN_SHARE * n, f"zoo {tag}: only {conv}/{n} experts converged")
    check(launches["block_chol"] > 0 and launches == want, f"zoo {tag} launches {launches}, expected {want}")

    # 16 experts spread over the run: their tiles alone, fitted in f64 on the
    # CPU from their f32 optima with the card's per-tile domain or knots
    # (the f32 tiles lay them over f32-rounded coordinates) through the
    # "cholesky" route; then the card's library arm (the "block" route's
    # f64 arm: the same cholesky + tri_inv_blocked) evaluates the bound and
    # the predictions at the CPU fit's parameters
    pick = np.sort(np.asarray(sorted(got)))[:: max(n // CPU_TILES, 1)][:CPU_TILES]
    sub = {c: v[pick] for c, v in experts.items()}
    ix = sel.local_select_indices_all(obs, sub, OI_KW["local_select"])
    pcs = PredictionLocations("from_dataframe", coords_col=["x", "y"], df=grid, max_dist=OI_MAX_DIST).batch_call(sub)
    tiles = batching.assemble_tiles(sel.columns_array(obs, ["x", "y"]), obs["z"], ix, pcs, expert_index=pick,
                                    expert_locs=sel.columns_array(sub, ["x", "y"]), coords_scale=ip["coords_scale"],
                                    obs_mean=ip["obs_mean"])
    check(len(tiles) == 1, f"zoo {tag}: the compared experts' tiles fill {len(tiles)} buckets, not one")
    batch = tiles[0]
    init = {k: np.stack([np.asarray(got[int(e)][k]) for e in batch.expert_index]).astype(np.float64)
            for k in core.param_names}
    lib = core_for(ip, cons, model_cls=get_model(name), factor="cholesky")
    t0 = time.perf_counter()
    runner = make_batched_runner(lib, fixed_params=core.default_fixed_params, max_iter=ZOO_REF_MAX_ITER,
                                 linesearch="single_eval", device="cpu")
    cpu = run_tile_batch(batch, init, runner, lib, device="cpu")
    cpu_s = time.perf_counter() - t0
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    card64 = run_tile_batch(batch, {k: cpu[k] for k in core.param_names},
                            make_batched_runner(core, optimise=False), core)
    card64_s = time.perf_counter() - t0
    card64_launches = launches_now()

    def preds(res, j):
        p = int(res["pred_mask"][j].sum())
        return {k: res[k][j][:p] for k in ("f_mean", "f_var")}

    def rel(a, b):
        return float(np.max(np.abs(np.asarray(a) - b) / np.maximum(1.0, np.abs(b))))

    # compare the experts whose f64 fit converged on the f32 fit's optimum
    # (objectives within 0.1 nat)
    rows = list(enumerate(batch.expert_index))
    same = [j for j, e in rows
            if cpu["converged"][j] and abs(cpu["objective"][j] - got[int(e)]["objective"]) <= SVGP_SAME_OPTIMUM_NATS]
    d = [max_abs_pred_diff(got[int(e)], preds(cpu, j)) for j, e in rows if j in same]
    d64 = max([rel(card64["objective"], cpu["objective"])]
              + [rel(preds(card64, j)[k], preds(cpu, j)[k]) for j, _ in rows for k in ("f_mean", "f_var")])
    log(f"zoo_{tag}_accuracy", experts=len(pick), compared=len(d),
        not_compared={int(e): {"cpu_f64_converged": bool(cpu["converged"][j]),
                               "cpu_f64_num_iter": int(cpu["num_iter"][j]),
                               "objectives_f32_f64": [float(got[int(e)]["objective"]), float(cpu["objective"][j])]}
                      for j, e in rows if j not in same},
        f32_vs_cpu_f64=max(d) if d else None, bound=PRED_BOUND, cpu_f64_s=cpu_s,
        cpu_f64_iters=cpu["num_iter"].tolist(), card_f64_vs_cpu_f64=d64, card_f64_bound=ZOO_CARD_F64_BOUND,
        card_f64_s=card64_s, card_f64_launches=card64_launches)
    check(len(d) >= MIN_COMPARED_SHARE * len(pick), f"zoo {tag}: {len(d)}/{len(pick)} experts compared")
    check(max(d) <= PRED_BOUND, f"zoo {tag}: card f32 vs CPU f64 {max(d)}")
    check(not any(card64_launches.values()), f"zoo {tag}: f64 on the card launched a kernel: {card64_launches}")
    check(d64 <= ZOO_CARD_F64_BOUND, f"zoo {tag}: card f64 vs CPU f64 {d64}")
    if profile:
        trace(f"zoo_{tag}", lambda: run(experts), f"profile_zoo_{tag}.txt")
    return launches["block_chol"]


def phase_zoo(profile: bool):
    """Phase 11: the VFF and ASVGP lanes. Returns kernel 1's launches in
    each."""
    t0 = time.perf_counter()
    lv = zoo_lane("vff", profile)
    la = zoo_lane("asvgp", profile)
    log("zoo", seconds=time.perf_counter() - t0)
    return lv, la


def host_data():
    """Phase 12's inputs: the verify recipe's 400 points (raw units), one
    tile of bench_large_n.py's N = 4,096, and the fullest expert of phase
    7's data within its 300 km selection with its prediction locations."""
    from gpsat_tpu_torch.data import select as sel

    rng = np.random.default_rng(0)
    x = rng.uniform(-3e5, 3e5, size=(HOST_N, 2))
    y = np.sin(x[:, 0] / 8e4) * np.cos(x[:, 1] / 1e5) + 0.05 * rng.normal(size=HOST_N)
    recipe = (x, y, rng.uniform(-2e5, 2e5, size=(HOST_P, 2)))
    t = make_large_tiles(1, SGPR_FULL[1], SGPR_P, D, np.float64)
    n = int(t.num_obs[0])
    tile = (t.X[0, :n], t.y[0, :n], t.Xnew[0])
    obs, experts, grid = pipeline_inputs()
    ix = sel.local_select_indices_all(obs, experts, OI_KW["local_select"])
    e = int(np.argmax([len(i) for i in ix]))
    loc = np.array([experts["x"][e], experts["y"][e]])
    pxy = np.stack([grid["x"], grid["y"]], axis=1)
    near = pxy[np.hypot(*(pxy - loc).T) <= OI_MAX_DIST]
    expert = (np.stack([obs["x"][ix[e]], obs["y"][ix[e]]], axis=1), obs["z"][ix[e]], near, loc)
    return recipe, tile, expert


def host_class(tag, make, opt, formula, Xnew, ref_opt=CPU_F64_KW):
    """One class of phase 12 (a). ``make(device, dtype)`` builds the model;
    the f32 fit and predict on the card run with every launch count set to 0
    just before and read just after (``formula(num_iter)`` is kernel 1's
    count); the CPU f64 fit starts from the f32 optimum; the card's f64
    objective and predictions are taken at the CPU fit's parameters. Returns
    kernel 1's launches."""
    import torch

    def launches_now():
        return {k: fn.launches for k, fn in counters().items()}

    m32 = make(None, torch.float32)
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    ok32 = m32.optimise_parameters(**opt)
    p32 = m32.predict(Xnew)
    torch.cuda.synchronize()
    s32 = time.perf_counter() - t0
    launches = launches_now()
    it = int(m32._last_opt_result.num_iter)
    want = {"block_chol": formula(it), "panel_chol": 0, "cholesky": 0, "mm3xtf32": 0}

    t0 = time.perf_counter()
    cpu = make("cpu", torch.float64)
    cpu.set_parameters(**m32.get_parameters())
    ok64 = cpu.optimise_parameters(**{**opt, **ref_opt, "max_iter": HOST_REF_MAX_ITER})
    pc = cpu.predict(Xnew)
    cpu_s = time.perf_counter() - t0
    d32 = max(float(np.max(np.abs(p32[k] - pc[k]))) for k in ("f*", "f*_var"))

    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    c64 = make(None, torch.float64)
    c64.set_parameters(**cpu.get_parameters())
    obj_card, obj_cpu = c64.get_objective_function_value(), cpu.get_objective_function_value()
    pg = c64.predict(Xnew)
    torch.cuda.synchronize()
    card64_s = time.perf_counter() - t0
    launches64 = launches_now()

    def rel(a, b):
        return float(np.max(np.abs(np.asarray(a) - b) / np.maximum(1.0, np.abs(b))))

    d64 = max([rel(obj_card, obj_cpu)] + [rel(pg[k], pc[k]) for k in ("f*", "f*_var", "y_var")])
    log(f"host_{tag}", model=type(m32).__name__, n=len(m32.coords), converged_f32=bool(ok32), num_iter_f32=it,
        f32_s=s32, launches=launches, launches_predicted=want, cpu_f64_converged=bool(ok64),
        cpu_f64_num_iter=int(cpu._last_opt_result.num_iter), cpu_f64_s=cpu_s, f32_vs_cpu_f64=d32,
        bound=PRED_BOUND, objective_card_f64=obj_card, objective_cpu_f64=obj_cpu, card_f64_vs_cpu_f64=d64,
        card_f64_bound=HOST_CARD_F64_BOUND, card_f64_s=card64_s, card_f64_launches=launches64)
    check(np.isfinite(p32["f*"]).all() and np.isfinite(p32["f*_var"]).all(), f"host {tag}: non-finite f32 predictions")
    check(not m32._last_opt_result.failed, f"host {tag}: the f32 fit failed after {it} iterations")
    check(launches["block_chol"] > 0 and launches == want, f"host {tag} launches {launches}, expected {want}")
    check(d32 <= PRED_BOUND, f"host {tag}: card f32 vs CPU f64 {d32}")
    check(not any(launches64.values()), f"host {tag}: f64 on the card launched a kernel: {launches64}")
    check(d64 <= HOST_CARD_F64_BOUND, f"host {tag}: card f64 vs CPU f64 {d64}")
    return launches["block_chol"]


def host_lane_experts(experts_n):
    """Phase 7's inputs and the first ``experts_n`` of its experts that have
    at least min_obs observations."""
    from gpsat_tpu_torch.data import select as sel

    obs, experts, grid = pipeline_inputs()
    ix = sel.local_select_indices_all(obs, experts, OI_KW["local_select"])
    keep = np.flatnonzero([len(i) >= OI_KW["min_obs"] for i in ix])[:experts_n]
    return obs, {c: v[keep] for c, v in experts.items()}, grid


def host_lane_sweep(model, experts_n, device, dtype):
    """The sweep's host-serial lane over the first ``experts_n`` of phase
    7's experts with phase 7's model settings and the model's own optimiser
    settings; (results by expert, seconds)."""
    from gpsat_tpu_torch.data.prediction_locations import PredictionLocations
    from gpsat_tpu_torch.experts import sweep

    obs, locs, grid = host_lane_experts(experts_n)
    pred_loc = PredictionLocations("from_dataframe", coords_col=["x", "y"], df=grid, max_dist=OI_MAX_DIST)
    kw = {**OI_KW, "model": model, "optim_kwargs": {}, "device": device, "dtype": dtype}
    t0 = time.perf_counter()
    out = [r for r in sweep(obs, locs, pred_loc=pred_loc, **kw) if not r.get("skipped")]
    return by_expert(out, ("f_mean", "f_var", "converged", "num_iter", "num_obs")), time.perf_counter() - t0


def host_profile_run(trace_dir: Path) -> int:
    """Phase 12 (c): LocalExpertOI.run(profile_dir=...) on the host-serial
    lane over phase 7's first HOST_TRACE_EXPERTS experts, HOST_TRACE_STEPS
    Adam steps each, its results store in a temporary directory. Returns the
    experts in the store's run_details."""
    import tempfile

    import pandas as pd

    from gpsat_tpu_torch.data.store import TableStore
    from gpsat_tpu_torch.experts import LocalExpertOI

    obs, locs, grid = host_lane_experts(HOST_TRACE_EXPERTS)
    oi = LocalExpertOI(
        expert_loc_config={"source": pd.DataFrame(locs)},
        data_config={"data_source": pd.DataFrame(obs), "obs_col": OI_KW["obs_col"],
                     "coords_col": OI_KW["coords_col"], "local_select": OI_KW["local_select"]},
        model_config={"oi_model": "GPyTorchGPRModel", "init_params": OI_KW["init_params"],
                      "constraints": OI_KW["constraints"], "optim_kwargs": {"n_iter": HOST_TRACE_STEPS}},
        pred_loc_config={"method": "from_dataframe", "df": pd.DataFrame(grid), "max_dist": OI_MAX_DIST},
    )
    with tempfile.TemporaryDirectory(prefix="chip_smoke_host_") as tmp:
        store = str(Path(tmp) / "host.h5")
        oi.run(store_path=store, min_obs=OI_KW["min_obs"], profile_dir=str(trace_dir))
        with TableStore(store, mode="r") as s:
            return len(s.select("run_details"))


def pure_numpy_lane():
    """Start PureNumpyGPR (numpy and scipy, no device) through the
    host-serial lane over (b)'s experts, in a child process with
    ``PURE_NUMPY_ENV`` that runs on the host's CPU while the parent drives
    the card; (the child, its start time) for ``pure_numpy_result``."""
    import os

    code = ("import json, sys, torch; sys.path.insert(0, sys.argv[1]); import chip_smoke as cs; "
            "r, s = cs.host_lane_sweep('PurePythonGPR', cs.HOST_LANE_EXPERTS, 'cpu', torch.float64); "
            "print(json.dumps({'experts': len(r), 'sweep_s': s, "
            "'converged': int(sum(v['converged'] for v in r.values())), "
            "'finite': bool(all(cs.np.isfinite(v['f_mean']).all() and cs.np.isfinite(v['f_var']).all() "
            "for v in r.values())), 'num_iter_mean': float(cs.np.mean([v['num_iter'] for v in r.values()]))}))")
    proc = subprocess.Popen([sys.executable, "-c", code, str(ROOT)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env={**os.environ, **PURE_NUMPY_ENV})
    return proc, time.perf_counter()


def pure_numpy_result(proc, t0) -> dict:
    """Wait for ``pure_numpy_lane``'s child: its summary, with its wall
    seconds."""
    out, err = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"host lane: the PureNumpyGPR child failed: {err[-2000:]}")
    return {**json.loads(out.strip().splitlines()[-1]), "child_s": time.perf_counter() - t0}


def phase_host():
    """Phase 12: (a) the five host-facing classes, (b) the host-serial
    lane, (c) a profile_dir trace. Returns kernel 1's launches per class."""
    t_phase = time.perf_counter()
    child = pure_numpy_lane()  # (b)'s CPU-only lane, beside (a)
    try:
        return host_phases(t_phase, child)
    finally:
        child[0].kill()  # a no-op once it has ended


def host_phases(t_phase, child):
    """Phase 12's parts, with (b)'s PureNumpyGPR child already started."""
    import torch

    from gpsat_tpu_torch.models import get_model

    (rx, ry, rnew), (tx, ty, tnew), (ex, ey, enew, eloc) = host_data()
    recipe = dict(coords=rx, obs=ry, coords_scale=[5e4, 5e4], obs_mean="local")
    expert = dict(coords=ex, obs=ey, coords_scale=[5e4, 5e4], obs_mean="local", noise_variance=0.0025)
    svgp_cfg = json.loads(SVGP_CONFIG.read_text())["model"]
    vff_cfg = json.loads(VFF_CONFIG.read_text())["model"]
    cons_raw = vff_cfg["constraints"]  # the two configs share it (raw units)

    def built(cls, kw, constraints, scale=False):
        def make(device, dtype):
            np.random.seed(0)  # the inducing points' draw
            m = get_model(cls)(**kw, device=device, dtype=dtype)
            m.set_parameter_constraints(constraints, scale=scale)
            return m
        return make

    recipe_cons = {"lengthscales": {"low": 0.1, "high": 20.0}}
    out = {}
    # one pair per evaluation ((it + 1) of them) and one in the predict,
    # W / 64 launches each; SGPR two pairs (Kuu and B) per evaluation and in
    # the predict; SVGP's collapsed solver two per evaluation, two in its
    # closed-form q and one (Kuu) in the predict
    out["gpr"] = host_class("gpr", built("GPflowGPRModel", recipe, recipe_cons), {"max_iter": HOST_MAX_ITER},
                            lambda it: (it + 2) * 7, rnew)
    out["sgpr"] = host_class("sgpr", built("GPflowSGPRModel", dict(coords=tx, obs=ty, num_inducing_points=SGPR_M),
                                           {}), {"max_iter": HOST_MAX_ITER},
                             lambda it: 2 * (it + 2) * 8, tnew)
    svgp_ip = {k: v for k, v in svgp_cfg["init_params"].items() if k in ("num_inducing_points", "likelihood")}
    out["svgp"] = host_class("svgp", built("GPflowSVGPModel", {**expert, **svgp_ip}, svgp_cfg["constraints"], True),
                             {"solver": "collapsed", "max_iter": HOST_MAX_ITER},
                             lambda it: 2 * (it + 1) + 3, enew, ref_opt={})
    vff_ip = {k: vff_cfg["init_params"][k] for k in ("kernel", "num_inducing_features", "domain_size")}
    out["vff"] = host_class("vff", built("GPflowVFFModel", {**expert, **vff_ip, "expert_loc": eloc}, cons_raw, True),
                            {"max_iter": HOST_MAX_ITER}, lambda it: (it + 2) * 6, enew)
    out["asvgp"] = host_class("asvgp", built("GPflowASVGPModel", {**recipe, "num_inducing_features": 20},
                                             recipe_cons), {"max_iter": HOST_MAX_ITER}, lambda it: (it + 2) * 7, rnew)
    a_s = time.perf_counter() - t_phase

    # (b) the host-serial lane: TorchGPRModel f64, card against CPU; PureNumpyGPR
    for fn in counters().values():
        fn.launches = 0
    card, card_s = host_lane_sweep("GPyTorchGPRModel", HOST_LANE_EXPERTS, None, torch.float64)
    lane_launches = {k: fn.launches for k, fn in counters().items()}
    cpu, cpu_s = host_lane_sweep("GPyTorchGPRModel", HOST_LANE_EXPERTS, "cpu", torch.float64)
    common = sorted(set(card) & set(cpu))
    d = max(max_abs_pred_diff(card[e], cpu[e]) for e in common)
    pnp = pure_numpy_result(*child)
    log("host_lane", experts=len(card), torch_card_f64_s=card_s, torch_cpu_f64_s=cpu_s,
        torch_card_experts_per_s=len(card) / card_s, card_vs_cpu_f64=d, bound=HOST_LANE_BOUND,
        launches=lane_launches, pure_numpy=pnp, pure_numpy_env=PURE_NUMPY_ENV)
    check(len(card) == len(cpu) == len(common) == pnp["experts"] > 0, "host lane: experts differ between the runs")
    check(d <= HOST_LANE_BOUND, f"host lane: TorchGPRModel card f64 vs CPU f64 {d}")
    check(pnp["finite"], "host lane: non-finite PureNumpyGPR predictions")
    check(pnp["converged"] >= MIN_SHARE * pnp["experts"],
          f"host lane: PureNumpyGPR converged {pnp['converged']}/{pnp['experts']}")

    # (c) profile_dir: the trace LocalExpertOI.run(profile_dir=...) writes
    trace_dir = ROOT / "chiprun_out" / "host_profile_dir"
    before = set(trace_dir.glob("*.pt.trace.json")) if trace_dir.exists() else set()
    stored = host_profile_run(trace_dir)
    traces = sorted(set(trace_dir.glob("*.pt.trace.json")) - before)
    log("host_profile_dir", traces=[str(t.relative_to(ROOT)) for t in traces],
        bytes=[t.stat().st_size for t in traces], stored_experts=stored)
    check(len(traces) == 1 and traces[0].stat().st_size > 0, f"host profile_dir: traces written {traces}")
    check(stored == HOST_TRACE_EXPERTS, f"host profile_dir: {stored} experts stored, {HOST_TRACE_EXPERTS} run")
    log("host", seconds=time.perf_counter() - t_phase, classes_s=a_s)
    return out


def mo_data():
    """Phase 13 (b)'s inputs: the verify recipe's 400 points in units of its
    coords_scale, its field and a second one as the two latents, seen
    through MO_H with the recipe's noise; 64 prediction points."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-3e5, 3e5, size=(HOST_N, 2))
    F = np.stack([np.sin(x[:, 0] / 8e4) * np.cos(x[:, 1] / 1e5), np.cos(x[:, 0] / 1.2e5) * np.sin(x[:, 1] / 9e4)],
                 axis=1)
    Y = F @ MO_H.T + 0.05 * rng.normal(size=(HOST_N, 2))
    return x / MO_SCALE, Y, rng.uniform(-2e5, 2e5, size=(HOST_P, 2)) / MO_SCALE


def mo_class(tag, make, fit32, fit_ref, formula, Xnew):
    """One multi-output class of phase 13 (b), as phase 12's classes: the
    f32 fit and predict on the card with every launch count set to 0 just
    before and read just after (``formula(m32)`` is kernel 1's count), an f64
    fit on the CPU from the f32 optimum, and the card's f64 objective and
    predictions at that fit's parameters. Returns kernel 1's launches."""
    import torch

    m32 = make(None, torch.float32)
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    ok32 = fit32(m32)
    p32 = m32.predict(Xnew)
    torch.cuda.synchronize()
    s32 = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    want = {"block_chol": formula(m32), "panel_chol": 0, "cholesky": 0, "mm3xtf32": 0}

    t0 = time.perf_counter()
    cpu = make("cpu", torch.float64)
    cpu._params = {k: np.asarray(v, dtype=np.float64) for k, v in m32._params.items()}
    ok64 = fit_ref(cpu)
    pc = cpu.predict(Xnew)
    cpu_s = time.perf_counter() - t0
    d32 = max(float(np.max(np.abs(p32[k] - pc[k]))) for k in ("f*", "f*_var"))

    for fn in counters().values():
        fn.launches = 0
    c64 = make(None, torch.float64)
    c64._params = dict(cpu._params)
    obj_card, obj_cpu = c64.get_objective_function_value(), cpu.get_objective_function_value()
    pg = c64.predict(Xnew)
    torch.cuda.synchronize()
    launches64 = {k: fn.launches for k, fn in counters().items()}

    def rel(a, b):
        return float(np.max(np.abs(np.asarray(a) - b) / np.maximum(1.0, np.abs(b))))

    d64 = max([rel(obj_card, obj_cpu)] + [rel(pg[k], pc[k]) for k in ("f*", "f*_var")])
    log(f"prep_mo_{tag}", model=type(m32).__name__, n=len(m32.coords), outputs=m32.H.shape[0],
        latents=m32.H.shape[1], ok_f32=bool(ok32), f32_s=s32, launches=launches, launches_predicted=want,
        cpu_f64_ok=bool(ok64), cpu_f64_s=cpu_s, f32_vs_cpu_f64=d32, bound=PRED_BOUND, objective_card_f64=obj_card,
        objective_cpu_f64=obj_cpu, card_f64_vs_cpu_f64=d64, card_f64_bound=HOST_CARD_F64_BOUND,
        card_f64_launches=launches64)
    check(np.isfinite(p32["f*"]).all() and np.isfinite(p32["f*_var"]).all(), f"prep mo {tag}: non-finite f32 predictions")
    check(ok32, f"prep mo {tag}: the f32 fit did not succeed")
    check(launches["block_chol"] > 0 and launches == want, f"prep mo {tag} launches {launches}, expected {want}")
    check(d32 <= PRED_BOUND, f"prep mo {tag}: card f32 vs CPU f64 {d32}")
    check(not any(launches64.values()), f"prep mo {tag}: f64 on the card launched a kernel: {launches64}")
    check(d64 <= HOST_CARD_F64_BOUND, f"prep mo {tag}: card f64 vs CPU f64 {d64}")
    return launches["block_chol"]


def phase_prep_multioutput():
    """Phase 13 (b): MultioutputGPRModel (S's pair through kernel 1, (it + 2)
    pairs of 832 / 64 = 13 launches: one per evaluation and one in the
    predict) and MultioutputSVGPModel (the L = 2 Kuu pairs of M = 64 in one
    launch per ELBO: one per Adam step and one in the predict)."""
    from gpsat_tpu_torch.models.multioutput import MultioutputGPRModel, MultioutputSVGPModel

    X, Y, Xnew = mo_data()
    width = -(-X.shape[0] * MO_H.shape[0] // T) * T

    def gpr(device, dtype):
        return MultioutputGPRModel(coords=X, obs=Y, H=MO_H, likelihood_variance=0.05**2, device=device, dtype=dtype)

    def svgp(device, dtype):
        return MultioutputSVGPModel(coords=X, obs=Y, H=MO_H, num_inducing_points=MO_M, likelihood_variance=0.05**2,
                                    device=device, dtype=dtype)

    out = {}
    out["gpr"] = mo_class(
        "gpr", gpr, lambda m: m.optimise_parameters(max_iter=MO_GPR_MAX_ITER),
        lambda m: m.optimise_parameters(max_iter=MO_REF_ITERS),
        lambda m: (int(m._last_opt_result.num_iter[0]) + 2) * width // T, Xnew)
    out["svgp"] = mo_class(
        "svgp", svgp, lambda m: m.optimise_parameters(max_iter=MO_ADAM_STEPS, learning_rate=MO_ADAM_LR),
        lambda m: m.optimise_parameters(max_iter=MO_REF_ITERS, learning_rate=MO_REF_LR),
        lambda m: MO_ADAM_STEPS + 1, Xnew)
    return out


def along_track_day(root):
    """A synthetic along-track day in lon/lat under ``root``: PREP_TRACKS
    ground tracks of a polar orbit (each a great-circle-like arc from 62 N
    over the pole region and back), one CSV per track with lon, lat, an
    observation z of phase 7's field plus noise, a datetime string and the
    day's date. Seed 0."""
    import pandas as pd

    from gpsat_tpu_torch.utils.projections import EASE2toWGS84

    rng = np.random.default_rng(0)
    n = PREP_TRACK_POINTS
    for t in range(PREP_TRACKS):
        # a straight line in EASE2 through a random point near the pole, as
        # long as the domain allows, back to lon/lat
        theta = rng.uniform(0, np.pi)
        off = rng.uniform(-1.5e6, 1.5e6)
        s_ = np.linspace(-3.2e6, 3.2e6, n)
        x = s_ * np.cos(theta) - off * np.sin(theta)
        y = s_ * np.sin(theta) + off * np.cos(theta)
        lon, lat = EASE2toWGS84(x, y)
        z = (0.3 * np.sin(x / 8e5) * np.cos(y / 6e5) + 0.2 * np.sin((x + y) / 1.5e6)
             + 0.05 * rng.standard_normal(n))
        times = pd.Timestamp("2020-03-01") + pd.to_timedelta(3000 * t + np.arange(n), unit="s")
        pd.DataFrame({"lon": lon, "lat": lat, "z": z, "datetime": times.strftime("%Y-%m-%d %H:%M:%S"),
                      "date": 20200301}).to_csv(f"{root}/track_{t:02d}.csv", index=False)


def phase_prep_data():
    """Phase 13 (c): CSV tracks -> ingest.read_flat_files (its @to_datetime
    col func) -> @WGS84toEASE2 -> BinData.bin_wrapper on phase 7's 50 km
    grid -> experts.sweep (GPR Matern32, f32, kernel 1) on the binned cells
    with phase 7's experts and model settings. Returns kernel 1's launches."""
    import tempfile

    import torch

    from gpsat_tpu_torch.data import dataloader as DL
    from gpsat_tpu_torch.data.binning import BinData
    from gpsat_tpu_torch.data.ingest import read_flat_files
    from gpsat_tpu_torch.data.prediction_locations import PredictionLocations
    from gpsat_tpu_torch.experts import sweep
    from gpsat_tpu_torch.parallel import batching

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        along_track_day(root)
        df = read_flat_files(root, r"track_\d+\.csv",
                             col_funcs={"datetime": {"func": "@to_datetime", "col_args": "datetime"}})
    check(np.issubdtype(df["datetime"].dtype, np.datetime64), "prep: @to_datetime left no datetime column")
    DL.add_cols(df, {("x", "y"): {"func": "@WGS84toEASE2", "col_args": ["lon", "lat"]}})
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rng_ = [-OI_EXTENT, OI_EXTENT]
    binned, _ = BinData.bin_wrapper(df.copy(), print_stats=False, by_cols="date", val_col="z", x_col="x", y_col="y",
                                    grid_res=OI_BIN, x_range=rng_, y_range=rng_)
    binned = binned.dropna().reset_index()
    bin_s = time.perf_counter() - t0

    # the same means by a plain group-by over the cells' integer indices
    edges = np.linspace(-OI_EXTENT, OI_EXTENT, int(2 * OI_EXTENT / OI_BIN) + 1)
    inside = (np.abs(df["x"]) <= OI_EXTENT) & (np.abs(df["y"]) <= OI_EXTENT)
    ix = np.clip(np.searchsorted(edges, df["x"][inside], side="right") - 1, 0, len(edges) - 2)
    iy = np.clip(np.searchsorted(edges, df["y"][inside], side="right") - 1, 0, len(edges) - 2)
    plain = df[inside].assign(ix=ix, iy=iy).groupby(["iy", "ix"])["z"].mean().sort_index()
    centres = (edges[:-1] + edges[1:]) / 2
    got = binned.set_index([np.searchsorted(centres, binned["y"]), np.searchsorted(centres, binned["x"])])["z"]
    got = got.sort_index()
    same_cells = bool(np.array_equal(np.asarray(got.index.tolist()), np.asarray(plain.index.tolist())))
    d_bin = float(np.abs(got.to_numpy() - plain.to_numpy()).max()) if same_cells else float("inf")

    obs = {c: binned[c].to_numpy() for c in ("x", "y", "z")}
    _, experts, grid = pipeline_inputs()
    pred_loc = PredictionLocations("from_dataframe", coords_col=["x", "y"], df=grid, max_dist=OI_MAX_DIST)
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = list(sweep(obs, experts, pred_loc=pred_loc, optim_kwargs={"max_iter": OI_OPTIM["max_iter"]}, **OI_KW))
    sweep_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    buckets = [r for r in out if not r.get("skipped")]
    n = sum(len(r["expert_index"]) for r in buckets)
    conv = sum(int(r["converged"].sum()) for r in buckets)
    nmax = batching.bucket_size(int(max(r["num_obs"].max() for r in buckets)))
    want = {"block_chol": kernel1_launches(buckets, nmax), "panel_chol": 0, "cholesky": 0, "mm3xtf32": 0}
    finite = all(np.isfinite(r["f_mean"]).all() and np.isfinite(r["f_var"]).all() for r in buckets)
    log("prep_data", tracks=PREP_TRACKS, raw_points=len(df), read_s=read_s, binned_cells=len(binned), bin_s=bin_s,
        binned_vs_numpy=d_bin, bin_bound=PREP_BIN_BOUND, same_cells=same_cells, experts_run=n,
        buckets=len(buckets), nmax_obs=int(max(r["num_obs"].max() for r in buckets)), sweep_s=sweep_s,
        experts_per_s=n / sweep_s, converged=conv, iters_max=int(max(r["num_iter"].max() for r in buckets)),
        launches=launches, launches_predicted=want)
    check(same_cells and d_bin <= PREP_BIN_BOUND, f"prep: binned means vs numpy group-by {d_bin} (cells equal: "
                                                  f"{same_cells})")
    check(n > 0 and finite, f"prep: {n} experts run, finite predictions {finite}")
    check(conv >= MIN_SHARE * n, f"prep: only {conv}/{n} experts converged")
    check(launches == want, f"prep sweep launches {launches}, expected {want}")
    return launches["block_chol"]


def phase_prep(batch, init, profile: bool):
    """Phase 13: (a) the profiled core with RationalQuadratic, (b) the
    multi-output models, (c) the data-preparation path. Returns kernel 3's
    and kernel 1's launches by part."""
    t0 = time.perf_counter()
    chol_a, block_a = phase_profiled(batch, init, profile, kernel=PREP_PROFILED_KERNEL, tag="prep_profiled_rq")
    a_s = time.perf_counter() - t0
    mo = phase_prep_multioutput()
    b_s = time.perf_counter() - t0 - a_s
    block_c = phase_prep_data()
    log("prep", seconds=time.perf_counter() - t0, a_s=a_s, b_s=b_s, c_s=time.perf_counter() - t0 - a_s - b_s)
    return chol_a, {"prep_profiled_rq": block_a, "prep_mo_gpr": mo["gpr"], "prep_mo_svgp": mo["svgp"],
                    "prep_data": block_c}


def mesh_sweep(mesh, locs=None, dtype=None, optim_kwargs=None, pad_multiple=OI_KW["pad_multiple"], index=None,
               timers=None):
    """Phase 7's sweep without the polish over ``mesh`` (None: no mesh) on
    the card, of ``locs`` (default all of phase 7's experts), its radius
    queries on ``index`` (None: the sweep's default, the grid): (buckets,
    seconds, kernel launches), the counts set to 0 just before it and read
    just after; seconds per phase into ``timers``."""
    import torch

    from gpsat_tpu_torch.data.prediction_locations import PredictionLocations
    from gpsat_tpu_torch.experts import sweep

    obs, experts, grid = pipeline_inputs()
    pred_loc = PredictionLocations("from_dataframe", coords_col=["x", "y"], df=grid, max_dist=OI_MAX_DIST)
    kw = {**OI_KW, "dtype": dtype or torch.float32, "optim_kwargs": optim_kwargs or MESH_OPTIM,
          "pad_multiple": pad_multiple, "index": index, "timers": timers}
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = [r for r in sweep(obs, experts if locs is None else locs, pred_loc=pred_loc, mesh=mesh, **kw)
           if not r.get("skipped")]
    seconds = time.perf_counter() - t0
    return out, seconds, {k: fn.launches for k, fn in counters().items()}


def shard_launches(buckets, n_shards):
    """Kernel 1's launches for a meshed sweep, derived from the code: each
    shard of each bucket (padded as the engine pads it, split in row order)
    runs one factor pair of Nmax/64 launches per value+grad (the initial one,
    one per iteration of the shard's slowest lane) and one in its predict."""
    from gpsat_tpu_torch.parallel import batching
    from gpsat_tpu_torch.parallel.engine import padded_width

    total, per_shard = 0, []
    for r in buckets:
        it = r["num_iter"]
        per = padded_width(len(it), OI_KW["pad_multiple"], n_shards) // n_shards
        nmax = batching.bucket_size(int(r["num_obs"].max()))
        for s in range(n_shards):
            rows = it[s * per:(s + 1) * per]
            check(len(rows) > 0, f"mesh: shard {s} of a bucket of {len(it)} holds no live expert")
            per_shard.append(int(rows.max()))
            total += (int(rows.max()) + 2) * (nmax // T)
    return total, per_shard


def mesh_frames(buckets, locs) -> dict:
    """The preds and run_details tables of a sweep's buckets (pandas, index
    columns as columns), rows of ``locs`` named by their coordinates."""
    import pandas as pd

    cat = {k: np.concatenate([r[k] for r in buckets]) for k in ("expert_index", "num_obs", "objective", "converged",
                                                                 "num_iter")}
    e = cat.pop("expert_index")
    return {"preds": preds_frame(buckets, locs),
            "run_details": pd.DataFrame({"x": locs["x"][e], "y": locs["y"][e], **cat})}


def mesh_config() -> dict:
    """Phase 7's settings as an experiment config, for run_token."""
    return {"model": {"oi_model": "GPflowGPRModel", "init_params": OI_KW["init_params"],
                      "constraints": OI_KW["constraints"], "optim_kwargs": MESH_OPTIM},
            "data": {"coords_col": OI_KW["coords_col"], "obs_col": OI_KW["obs_col"],
                     "local_select": OI_KW["local_select"]},
            "pred_loc": {"method": "from_dataframe", "max_dist": OI_MAX_DIST}}


def f64_width_probe(seed=0) -> dict:
    """Whether the card's f64 library calls of the GPR path give a matrix
    the same bits in a batch of 32 as in a batch of 128: max |a - b| over
    the first 32 of 128 SPD matrices of 128 rows, per call."""
    import torch

    g = torch.Generator().manual_seed(seed)
    A = torch.randn(128, 128, 128, dtype=torch.float64, generator=g).cuda()
    K = A @ A.transpose(1, 2) / 128 + torch.eye(128, dtype=torch.float64, device="cuda")
    v = torch.randn(128, 128, 1, dtype=torch.float64, generator=g).cuda()
    calls = {
        "cholesky_ex": lambda K, v: torch.linalg.cholesky_ex(K)[0],
        "solve_triangular": lambda K, v: torch.linalg.solve_triangular(torch.linalg.cholesky_ex(K)[0], v,
                                                                       upper=False),
        "bmm": lambda K, v: K @ K,
        "sum": lambda K, v: K.sum(-1),
    }
    return {k: float((f(K, v)[:32] - f(K[:32].contiguous(), v[:32].contiguous())).abs().max())
            for k, f in calls.items()}


def mesh_child(process_id: int, num_processes: int, port: int, out_dir: str) -> None:
    """Phase 14 (c), one child process: join the gloo group, make ready
    (imports, the card's context, this process's partition_expert_locs share
    of phase 7's experts), wait for the parent's go file, sweep the share on
    the local mesh, check its kernel-1 launches, write its frames and print
    a summary line."""
    import pickle

    import pandas as pd
    import torch
    import torch.distributed as dist

    from gpsat_tpu_torch import distributed as TD

    t0 = time.perf_counter()
    pid, nproc = TD.init_distributed(f"localhost:{port}", num_processes, process_id)
    try:
        _, experts, _ = pipeline_inputs()
        table = pd.DataFrame(experts)
        token = TD.run_token(mesh_config(), table)
        share = TD.partition_expert_locs(table, nproc, pid)
        locs = {c: share[c].to_numpy() for c in share.columns}
        mesh = TD.local_mesh()
        torch.zeros(1, device=mesh[0])
        ready_s = time.perf_counter() - t0
        go = Path(out_dir) / "go"
        while not go.exists():
            check(time.perf_counter() - t0 < 300, f"mesh child {pid}: no go file after 300 s")
            time.sleep(0.01)
        waited_s = time.perf_counter() - t0 - ready_s
        buckets, seconds, launches = mesh_sweep(mesh, locs)
        expected, _ = shard_launches(buckets, len(mesh))
        check(launches["block_chol"] == expected, f"mesh child {pid}: launches {launches}, expected {expected}")
        with open(Path(out_dir) / f"h{pid}.pkl", "wb") as f:
            pickle.dump(mesh_frames(buckets, locs), f)
        dist.barrier()  # every child has written its frames
        print(json.dumps({"process": pid, "processes": nproc, "token": token, "experts": len(share),
                          "run": int(sum(len(r["num_iter"]) for r in buckets)), "ready_s": ready_s,
                          "waited_s": waited_s, "sweep_s": seconds,
                          "launches": launches, "expected_block_chol": expected,
                          "mesh": [str(d) for d in mesh]}), flush=True)
    finally:
        dist.destroy_process_group()


def start_mesh_children(out_dir: str) -> list:
    """Phase 14 (c): start the children on a free localhost port. They make
    ready while the parent runs (a) and (b), and sweep when the parent
    writes ``out_dir``/go."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    return [subprocess.Popen([sys.executable, "-c", MESH_CHILD_CODE, str(ROOT), str(h), str(MESH_CHILDREN), str(port),
                              out_dir], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env={**os.environ, "OMP_NUM_THREADS": "1"})
            for h in range(MESH_CHILDREN)]


def finish_mesh_children(procs: list, out_dir: str) -> list:
    """Let the children sweep and wait for them: their summaries, in process
    order. A child that fails fails the phase."""
    (Path(out_dir) / "go").touch()
    outs = [p.communicate(timeout=300) for p in procs]
    for h, (p, (out, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"mesh: child {h} failed ({p.returncode}): {err[-3000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def phase_mesh(f32_oi):
    """Phase 14: (a) the sweep over the default mesh of the one card, (b)
    over two shards, and its f64 check, (c) two child processes over gloo.
    Returns kernel 1's launches in (a), (b) and the children."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        procs = start_mesh_children(out_dir)  # (c)'s children make ready meanwhile
        try:
            return mesh_parts(f32_oi, t_phase, procs, out_dir)
        finally:
            for p in procs:
                p.kill()  # a no-op once it has ended


def mesh_parts(f32_oi, t_phase, procs, out_dir):
    """Phase 14's parts, with (c)'s children started."""
    import pickle

    import torch

    from gpsat_tpu_torch import distributed as TD
    from gpsat_tpu_torch.data import select as sel
    from gpsat_tpu_torch.parallel.engine import default_mesh, padded_width, resolve_mesh, run_on_mesh

    # no fallback: a missing card, a mixed mesh and a failed shard raise
    refused = {}
    for tag, bad, err in (("missing_card", [f"cuda:{torch.cuda.device_count()}"], RuntimeError),
                          ("mixed", ["cpu", "cuda:0"], ValueError)):
        try:
            resolve_mesh(bad)
        except err as e:
            refused[tag] = str(e)
    try:
        run_on_mesh(default_mesh([0, 0]), lambda d, x: 1 / 0 if x[0] > 0 else {"x": x}, (torch.arange(2),))
    except ZeroDivisionError as e:
        refused["failed_shard"] = f"{e} ({'; '.join(getattr(e, '__notes__', []))})"
    check(len(refused) == 3, f"mesh: refusals {refused}")

    # (a) the default mesh: the one card, one shard
    mesh_a = default_mesh()
    a, a_s, launches_a = mesh_sweep(mesh_a)
    by_a = by_expert(a, ("f_mean", "f_var", "objective", "converged", "num_iter"))
    d_phase7 = max(float(np.abs(by_a[e]["f_mean"] - f32_oi[e]["f_mean"]).max()) for e in f32_oi)
    expected_a, _ = shard_launches(a, len(mesh_a))
    log("mesh_default", mesh=[str(d) for d in mesh_a], experts=len(by_a), seconds=a_s,
        converged=int(sum(v["converged"] for v in by_a.values())), launches=launches_a,
        expected_block_chol=expected_a, max_abs_f_mean_vs_phase7=d_phase7, bound=MESH_SAME_BOUND)
    check(set(by_a) == set(f32_oi), f"mesh (a): {len(by_a)} experts, phase 7 ran {len(f32_oi)}")
    check(d_phase7 <= MESH_SAME_BOUND, f"mesh (a) vs phase 7's f32 fit: {d_phase7}")
    check(launches_a == {"block_chol": expected_a, "panel_chol": 0, "cholesky": 0, "mm3xtf32": 0}, f"mesh (a) launches {launches_a}")

    # (b) two shards: every card, or the card twice (two host threads)
    mesh_b = default_mesh() if torch.cuda.device_count() > 1 else default_mesh([0, 0])
    b, b_s, launches_b = mesh_sweep(mesh_b)
    by_b = by_expert(b, ("f_mean", "f_var", "objective", "converged", "num_iter"))
    expected_b, it_shards = shard_launches(b, len(mesh_b))
    n = len(by_b)
    conv = int(sum(v["converged"] for v in by_b.values()))
    both = [e for e in by_b if by_b[e]["converged"] and by_a[e]["converged"]
            and abs(by_b[e]["objective"] - by_a[e]["objective"]) <= WORSE_OPTIMUM_NATS]
    d_b = max(max_abs_pred_diff(by_b[e], by_a[e]) for e in both)
    same_iter = sum(by_b[e]["num_iter"] == by_a[e]["num_iter"] for e in by_b)

    # phase 7's first 64 experts with >= min_obs observations, f64 on the
    # card, one bucket of 64 (no pad_multiple): over the mesh (two shards of
    # 32), against each shard's experts alone with no mesh (a bucket of 32,
    # the shard's width), and against the whole bucket with no mesh. The
    # card's f64 library kernels round by batch width (a triangular solve
    # of 128 matrices differs from one of 32 in the last bit), and a lane
    # near a flat optimum may then stop an iteration apart (F64_BOUND,
    # MESH_F64_ITER_LANES)
    obs, experts, _ = pipeline_inputs()
    ix = sel.local_select_indices_all(obs, experts, OI_KW["local_select"])
    keep = np.flatnonzero([len(i) >= OI_KW["min_obs"] for i in ix])[:MESH_F64_EXPERTS]
    locs64 = {c: v[keep] for c, v in experts.items()}
    f64_kw = dict(dtype=torch.float64, optim_kwargs={**MESH_OPTIM, "linesearch": "single_eval"}, pad_multiple=None)
    f64_mesh, f64_mesh_s, launches_f64 = mesh_sweep(mesh_b, locs64, **f64_kw)
    check(len(f64_mesh) == 1, f"mesh (b) f64: {len(f64_mesh)} buckets")
    rows = f64_mesh[0]["expert_index"]
    per = padded_width(len(rows), None, len(mesh_b)) // len(mesh_b)
    alone, f64_alone_s = {}, 0.0
    for sh in range(len(mesh_b)):
        part = rows[sh * per:(sh + 1) * per]
        out, sec, _ = mesh_sweep(None, {c: v[part] for c, v in locs64.items()}, **f64_kw)
        f64_alone_s += sec
        for e, v in by_expert(out, ("f_mean", "f_var", "num_iter")).items():
            alone[int(part[e])] = v
    f64_whole, f64_whole_s, _ = mesh_sweep(None, locs64, **f64_kw)
    m64 = by_expert(f64_mesh, ("f_mean", "f_var", "num_iter"))
    w64 = by_expert(f64_whole, ("f_mean", "f_var", "num_iter"))
    d_f64 = max(max_abs_pred_diff(m64[e], alone[e]) for e in alone)
    other_iter = [e for e in w64 if m64[e]["num_iter"] != w64[e]["num_iter"]]
    d_whole = max((max_abs_pred_diff(m64[e], w64[e]) for e in w64 if e not in other_iter), default=0.0)
    d_whole_other = max((max_abs_pred_diff(m64[e], w64[e]) for e in other_iter), default=0.0)
    width_probe = f64_width_probe()
    log("mesh_two_shards", mesh=[str(d) for d in mesh_b], experts=n, seconds=b_s, seconds_default_mesh=a_s,
        converged=conv, iters_max_by_shard=it_shards, launches=launches_b, expected_block_chol=expected_b,
        same_num_iter_as_default=same_iter, compared=len(both), max_abs_pred_diff_vs_default=d_b,
        bound=PRED_BOUND, f64_experts=len(m64), f64_shard_width=per, f64_seconds_mesh=f64_mesh_s,
        f64_seconds_shards_alone=f64_alone_s, f64_max_abs_mesh_vs_shards_alone=d_f64, f64_bound=MESH_F64_BOUND,
        f64_same_num_iter_as_shards_alone=int(sum(m64[e]["num_iter"] == alone[e]["num_iter"] for e in alone)),
        f64_seconds_whole_bucket=f64_whole_s, f64_max_abs_mesh_vs_whole_bucket_same_num_iter=d_whole,
        f64_lanes_other_num_iter_than_whole_bucket=other_iter, f64_max_abs_mesh_vs_whole_bucket_other_num_iter=(
            d_whole_other), f64_whole_bucket_bound=F64_BOUND, f64_other_num_iter_lanes=MESH_F64_ITER_LANES,
        f64_launches=launches_f64, f64_width_probe=width_probe)
    check(set(by_b) == set(by_a), f"mesh (b): {n} experts, (a) ran {len(by_a)}")
    check(conv >= MIN_SHARE * n, f"mesh (b): only {conv}/{n} converged")
    check(launches_b == {"block_chol": expected_b, "panel_chol": 0, "cholesky": 0, "mm3xtf32": 0}, f"mesh (b) launches {launches_b}")
    check(len(both) >= MIN_SHARE * n, f"mesh (b): both converged on one optimum on {len(both)}/{n}")
    check(d_b <= PRED_BOUND, f"mesh (b) vs (a): {d_b}")
    check(len(m64) == len(alone) == len(w64) == MESH_F64_EXPERTS, f"mesh (b) f64: {len(m64)}, {len(alone)} experts")
    check(d_f64 <= MESH_F64_BOUND, f"mesh (b) f64 with the mesh vs its shards alone without it: {d_f64}")
    check(max(d_whole, d_whole_other) <= F64_BOUND and len(other_iter) <= MESH_F64_ITER_LANES,
          f"mesh (b) f64 with the mesh vs the whole bucket: max |diff| {d_whole} where num_iter is equal, "
          f"{d_whole_other} on lanes {other_iter} that stopped at another iteration")
    check(not any(launches_f64.values()), f"mesh (b) f64 launched kernels: {launches_f64}")

    # (c) child processes over gloo, each on its partition of the experts
    t0 = time.perf_counter()
    children = finish_mesh_children(procs, out_dir)
    hosts = []
    for h in range(MESH_CHILDREN):
        with open(Path(out_dir) / f"h{h}.pkl", "rb") as f:
            hosts.append(pickle.load(f))
    c_s = time.perf_counter() - t0
    index_cols = {"preds": ["x", "y"], "run_details": ["x", "y"]}
    merged = TD.merge_frames(hosts, index_cols)
    single = TD.merge_frames([mesh_frames(a, experts)], index_cols)
    keys = ["x", "y", "pred_loc_x", "pred_loc_y"]
    same_rows = (len(merged["preds"]) == len(single["preds"])
                 and all(np.array_equal(merged["preds"][k].to_numpy(), single["preds"][k].to_numpy()) for k in keys)
                 and np.array_equal(merged["run_details"][["x", "y"]].to_numpy(),
                                    single["run_details"][["x", "y"]].to_numpy()))
    conv_c = dict(zip(zip(merged["run_details"]["x"], merged["run_details"]["y"]), merged["run_details"]["converged"]))
    conv_a = dict(zip(zip(single["run_details"]["x"], single["run_details"]["y"]), single["run_details"]["converged"]))
    rows = np.asarray([bool(conv_c[k] and conv_a[k]) for k in zip(merged["preds"]["x"], merged["preds"]["y"])])
    d_c = max(float(np.abs(merged["preds"][k].to_numpy()[rows] - single["preds"][k].to_numpy()[rows]).max())
              for k in ("f*", "f*_var")) if same_rows and rows.any() else float("inf")
    tokens = {c["token"] for c in children}
    launches_c = [c["launches"]["block_chol"] for c in children]
    log("mesh_processes", processes=MESH_CHILDREN, seconds=c_s, children=children, merged_rows=len(merged["preds"]),
        rows_of_a=len(single["preds"]), same_rows_same_order=bool(same_rows), compared_rows=int(rows.sum()),
        max_abs_pred_diff_vs_default=d_c, bound=PRED_BOUND, tokens_equal=len(tokens) == 1,
        kernel1_launches=launches_c)
    check(same_rows, "mesh (c): the merged frames do not hold (a)'s rows in (a)'s order")
    check(rows.sum() >= MIN_SHARE * len(rows), f"mesh (c): both converged on {int(rows.sum())}/{len(rows)} rows")
    check(d_c <= PRED_BOUND, f"mesh (c) vs (a): {d_c}")
    check(len(tokens) == 1, f"mesh (c): the children's run tokens differ: {tokens}")
    phase_s = time.perf_counter() - t_phase
    log("mesh", seconds=phase_s, budget_s=MESH_BUDGET_S, a_s=a_s, b_s=b_s, c_s=c_s, refused=refused)
    return launches_a["block_chol"], launches_b["block_chol"], sum(launches_c)


def xval_data():
    """Phase 15's along-track data (synthetic.py, numpy seed 0): tracks
    sampled from the ground-truth field with noise, a fold column (track
    mod 4), and the noise-free truth at every point."""
    from gpsat_tpu_torch import synthetic as S

    tracks = S.make_tracks(extent=XVAL_EXTENT, n_tracks=XVAL_TRACKS, pts_per_track=XVAL_TRACK_POINTS, seed=0)
    field, xg, yg = S.make_ground_truth_field(extent=XVAL_EXTENT, n=XVAL_FIELD_N, seed=0)
    df = S.sample_from_ground_truth(tracks, field, xg, yg, noise_std=XVAL_NOISE, seed=0, keep_cols=["track"])
    df["fold"] = df["track"] % XVAL_FOLDS
    return df, S.interp_2d(field, xg, yg, df["x"].to_numpy(), df["y"].to_numpy())


def xval_index(host_build_s):
    """Phase 15 (a): the grid index against the kdtree on phase 7's
    geometry, then phase 7's f32 sweep on each arm. Returns kernel 1's
    launches in the grid sweep."""
    from gpsat_tpu_torch.data import select as sel
    from gpsat_tpu_torch.data.prediction_locations import PredictionLocations

    obs, experts, grid = pipeline_inputs()
    sets, secs = {}, {}
    for index in ("grid", "kdtree"):
        t0 = time.perf_counter()
        ix = sel.local_select_indices_all(obs, experts, OI_KW["local_select"], index=index)
        t1 = time.perf_counter()
        pcs = PredictionLocations("from_dataframe", coords_col=["x", "y"], df=grid, max_dist=OI_MAX_DIST,
                                  index=index).batch_call(experts)
        secs[index] = {"local_select_s": t1 - t0, "prediction_locations_s": time.perf_counter() - t1}
        sets[index] = (ix, pcs)
    same_select = all(np.array_equal(a, b) for a, b in zip(sets["grid"][0], sets["kdtree"][0]))
    same_pred = all(np.array_equal(a, b) for a, b in zip(sets["grid"][1], sets["kdtree"][1]))
    sweeps = {}
    for index in ("grid", "kdtree"):
        timers = {}
        buckets, sec, launches = mesh_sweep(None, index=index, timers=timers)
        sweeps[index] = (by_expert(buckets, ("f_mean", "f_var", "converged")), sec, launches, timers, buckets)
    g, k = sweeps["grid"][0], sweeps["kdtree"][0]
    d = max(float(np.abs(g[e][key] - k[e][key]).max()) for e in k for key in ("f_mean", "f_var")) if set(g) == set(
        k) else float("inf")
    expected, _ = shard_launches(sweeps["grid"][4], 1)
    launches = sweeps["grid"][2]
    log("xval_index", host_build_s=host_build_s, experts=len(experts["x"]), observations=len(obs["x"]),
        prediction_points=int(sum(len(p) for p in sets["grid"][1])),
        selected=int(sum(len(i) for i in sets["grid"][0])), host_s=secs, same_local_select=same_select,
        same_prediction_locations=same_pred, sweep_s={i: sweeps[i][1] for i in sweeps},
        sweep_host_select_s={i: sweeps[i][3].get("host_select") for i in sweeps}, experts_run=len(g),
        converged=int(sum(v["converged"] for v in g.values())), max_abs_grid_vs_kdtree=d, launches=launches,
        expected_block_chol=expected)
    check(same_select, "xval (a): the grid's local-select sets differ from the kdtree's")
    check(same_pred, "xval (a): the grid's prediction locations differ from the kdtree's")
    check(d == 0.0, f"xval (a): the grid sweep's predictions differ from the kdtree sweep's by {d}")
    check(launches == {"block_chol": expected, "panel_chol": 0, "cholesky": 0, "mm3xtf32": 0}, f"xval (a) launches {launches}")
    return launches["block_chol"]


def xval_stores(out_dir: Path):
    """Phase 15 (b): the data as zarr stores of blosc lz4 chunks, byte- and
    bit-shuffled, read back through the dataloader; every chunk through the
    C++ loops and the Python decoders. Returns (data, truth, the
    byte-shuffled store's path, the experts store's path)."""
    from gpsat_tpu_torch.data import dataloader as DL
    from gpsat_tpu_torch.data import zarr_reader as Z
    from gpsat_tpu_torch.data.blosc import blosc_decode
    from gpsat_tpu_torch.data.expert_locations import generate_local_expert_locations
    from gpsat_tpu_torch.utils.grids import grid_2d_flatten

    t0 = time.perf_counter()
    df, truth = xval_data()
    cols = ["x", "y", "track", "obs", "fold"]
    stores, reads, chunks = {}, {}, {"chunks": 0, "bytes": 0, "lz4_frames": 0, "native_s": 0.0, "python_s": 0.0}
    for shuffle, name in ((1, "byte_shuffle"), (2, "bit_shuffle")):
        path = out_dir / f"obs_lz4_{name}.zarr"
        Z.write_zarr(str(path), {c: (("index",), df[c].to_numpy()) for c in cols},
                     coords={"index": np.arange(len(df))}, compress="blosc", shuffle=shuffle, chunks=(XVAL_CHUNK,))
        t = time.perf_counter()
        got = DL.load(source=str(path))
        reads[name] = time.perf_counter() - t
        check(list(got.columns) == ["index", *sorted(cols)], f"xval (b): {name} store columns {list(got.columns)}")
        for c in cols:
            check(got[c].dtype == df[c].dtype and np.array_equal(got[c].to_numpy(), df[c].to_numpy()),
                  f"xval (b): column {c} of the {name} store differs from what was written")
        check(np.array_equal(got["index"].to_numpy(), np.arange(len(df))), f"xval (b): {name} store's index")
        for arr in sorted(p for p in path.iterdir() if p.is_dir()):
            for chunk in sorted(f for f in arr.iterdir() if not f.name.startswith(".")):
                buf = chunk.read_bytes()
                t = time.perf_counter()
                native = blosc_decode(buf, decoder="native")
                t1 = time.perf_counter()
                python = blosc_decode(buf, decoder="python")
                chunks["native_s"] += t1 - t
                chunks["python_s"] += time.perf_counter() - t1
                check(native == python, f"xval (b): chunk {chunk.relative_to(out_dir)} decodes differently")
                chunks["chunks"] += 1
                chunks["bytes"] += len(native)
                chunks["lz4_frames"] += int(not buf[2] & 0x02 and (buf[2] >> 5) & 7 == 1)
        stores[name] = path
    g = grid_2d_flatten([-XVAL_EXTENT, XVAL_EXTENT], [-XVAL_EXTENT, XVAL_EXTENT], grid_res=XVAL_EXPERT_RES,
                        center=False)
    locs = generate_local_expert_locations({"x": np.unique(g[:, 0]), "y": np.unique(g[:, 1])})
    experts = out_dir / "experts.zarr"
    Z.write_zarr(str(experts), {c: (("index",), locs[c].to_numpy()) for c in ("x", "y")},
                 coords={"index": np.arange(len(locs))}, compress="blosc")
    log("xval_stores", rows=len(df), tracks=XVAL_TRACKS, folds=XVAL_FOLDS, experts=len(locs), read_s=reads,
        chunk_rows=XVAL_CHUNK, **chunks, seconds=time.perf_counter() - t0)
    check(len(locs) == 121, f"xval (b): {len(locs)} expert locations, expected 121")
    check(chunks["lz4_frames"] > 0, "xval (b): no chunk was lz4-compressed")
    return df, truth, stores["byte_shuffle"], experts


def xval_fold(cfg, device, dtype, loaded=None):
    """One hold-out config through LocalExpertOI's setters and the sweep on
    ``device`` (None: the card); with ``loaded`` (name -> [E, ...]) a
    predict-only run at those parameters: (buckets, the LocalExpertOI, the
    training frame, seconds)."""
    from gpsat_tpu_torch.experts import LocalExpertOI, sweep

    t0 = time.perf_counter()
    oi = LocalExpertOI(expert_loc_config=cfg["locations"], data_config=cfg["data"], model_config=cfg["model"],
                       pred_loc_config=cfg["pred_loc"])
    train = oi.data.load(reset_index=True)
    out = list(sweep(train, oi.expert_locs, coords_col=oi.data.coords_col, obs_col=oi.data.obs_col,
                     local_select=oi.data.local_select, pred_loc=oi.pred_loc, model=oi.model,
                     init_params=oi.model_init_params, constraints=oi.constraints, optim_kwargs=oi.optim_kwargs,
                     optimise=loaded is None, loaded_params=loaded, dtype=dtype, device=device))
    return [r for r in out if not r.get("skipped")], oi, train, time.perf_counter() - t0


def xval_run(df, truth, store, experts, out_dir: Path):
    """Phase 15 (c): xval.main on the reference config, each hold-out
    config swept on the card, scored against the noise-free truth and
    against the CPU's f64 predictions at the card's optima. Returns kernel
    1's launches over the four folds."""
    import pandas as pd
    import torch

    from gpsat_tpu_torch import xval
    from gpsat_tpu_torch.data import select as sel
    from gpsat_tpu_torch.experts import core_for
    from gpsat_tpu_torch.parallel import batching
    from gpsat_tpu_torch.parallel.engine import make_batched_runner, run_tile_batch

    ref = {"data": {"data_source": str(store), "obs_col": "obs", "coords_col": ["x", "y"],
                    "local_select": [{"col": ["x", "y"], "comp": "<", "val": XVAL_RADIUS}]},
           "locations": {"source": str(experts), "keep_cols": ["x", "y"]},
           "model": XVAL_MODEL, "run_kwargs": {"store_path": str(out_dir / "xval.h5")},
           "pred_loc": {"method": "from_source"}, "comment": "chip_smoke phase 15"}
    config = {"ref_config": ref,
              "xval_config": {"pred_loc": {"method": "from_source", "max_dist": XVAL_RADIUS},
                              "row_select_values": ["fold"], "func": "lambda fold: fold == {fold}",
                              "col_args": "fold", "output_file": str(out_dir / "xval.h5")},
              "output_config_file": str(out_dir / "xval_configs.json")}
    t0 = time.perf_counter()
    xval.main(config)
    configs = json.loads((out_dir / "xval_configs.json").read_text())
    expand_s = time.perf_counter() - t0
    check(len(configs) == XVAL_FOLDS, f"xval (c): {len(configs)} hold-out configs, expected {XVAL_FOLDS}")

    ip, cons = XVAL_MODEL["init_params"], XVAL_MODEL["constraints"]
    core = core_for(ip, cons)
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    folds = []
    for cfg in configs:
        buckets, oi, train, sec = xval_fold(cfg, None, torch.float32)  # None: the card
        folds.append((cfg, buckets, oi, train, sec))
    launches = {k: fn.launches for k, fn in counters().items()}
    expected = sum((int(r["num_iter"].max()) + 2) * (batching.bucket_size(int(r["num_obs"].max())) // T)
                   for f in folds for r in f[1])
    fit_s = [f[4] for f in folds]

    rows, n_run, n_conv = [], 0, 0
    t0 = time.perf_counter()
    for k, (cfg, buckets, oi, train, _) in enumerate(folds):
        locs = {c: oi.expert_locs[c].to_numpy() for c in ("x", "y")}
        E = len(locs["x"])
        # the card's optima, row-aligned with the expert locations
        loaded = {name: np.full((E,) + np.shape(v), np.nan) for name, v in
                  core.init_cparams(2, dtype=np.float64).items()}
        for r in buckets:
            for name in loaded:
                loaded[name][r["expert_index"]] = r[name]
        cpu, _, _, _ = xval_fold(cfg, "cpu", torch.float64, loaded=loaded)
        held = df[df["fold"] == int(cfg["pred_loc"]["load_kwargs"]["row_select"][-1]["func"].split("==")[-1])]
        tr = pd.DataFrame({"pred_loc_x": held["x"].to_numpy(), "pred_loc_y": held["y"].to_numpy(),
                       "truth": truth[held.index.to_numpy()]})
        score = {tag: xval.score_xval_predictions({f"preds_{k}": preds_frame(b, locs)}, tr, "truth",
                                                  inference_radius=XVAL_RADIUS).iloc[0]
                 for tag, b in (("card_f32", buckets), ("cpu_f64", cpu))}
        rows.append({"fold": k, "experts": E, "run": int(sum(len(r["expert_index"]) for r in buckets)),
                     "held_out": len(held), "training": len(train), "scored": int(score["card_f32"]["n"]),
                     "rmse_card_f32": float(score["card_f32"]["rmse"]), "rmse_cpu_f64": float(score["cpu_f64"]["rmse"]),
                     "nll_card_f32": float(score["card_f32"]["nll"]), "nll_cpu_f64": float(score["cpu_f64"]["nll"])})
        n_run += rows[-1]["run"]
        n_conv += int(sum(r["converged"].sum() for r in buckets))
    score_s = time.perf_counter() - t0

    # 16 experts of fold 0 fitted again in f64 on the CPU, from the card's f32
    # optima (the shared init's fit took 14.9 s of the phase, PERF.md
    # section 4)
    cfg, buckets, oi, train, _ = folds[0]
    card = by_expert(buckets, ("f_mean", "f_var", "objective", *core.param_names))
    ran = np.sort(np.asarray(list(card)))
    pick = ran[:: max(len(ran) // CPU_TILES, 1)][:CPU_TILES]
    sub = {c: oi.expert_locs[c].to_numpy()[pick] for c in ("x", "y")}
    ix = sel.local_select_indices_all(train, sub, cfg["data"]["local_select"])
    pcs = oi.pred_loc.batch_call(sub)
    tiles = batching.assemble_tiles(sel.columns_array(train, ["x", "y"]), train["obs"], ix, pcs, expert_index=pick,
                                    coords_scale=ip["coords_scale"])
    t0 = time.perf_counter()
    runner = make_batched_runner(core, device="cpu", max_iter=XVAL_REF_MAX_ITER, **CPU_F64_KW)
    parts = [run_tile_batch(b, {name: np.stack([card[int(e)][name] for e in b.expert_index])
                                for name in core.param_names}, runner, core, device="cpu") for b in tiles]
    ref64 = {k: [row for p in parts for row in p[k]] for k in ("expert_index", "pred_mask", "f_mean", "f_var")}
    ref64["objective"] = np.concatenate([p["objective"] for p in parts])
    cpu_fit_s = time.perf_counter() - t0
    d = np.zeros(len(pick))
    f32_obj = np.zeros(len(pick))
    for j, e in enumerate(ref64["expert_index"]):
        p = int(ref64["pred_mask"][j].sum())
        f32_obj[j] = card[int(e)]["objective"]
        d[j] = max(float(np.abs(card[int(e)][key][:p] - ref64[key][j][:p]).max()) for key in ("f_mean", "f_var"))
    check(len(ref64["expert_index"]) == len(pick), f"xval (c): {len(ref64['expert_index'])} CPU lanes")
    same = np.abs(ref64["objective"] - f32_obj) <= WORSE_OPTIMUM_NATS
    rel = [abs(r["rmse_card_f32"] - r["rmse_cpu_f64"]) / r["rmse_cpu_f64"] for r in rows]
    log("xval", folds=rows, expand_s=expand_s, fit_s=fit_s, score_s=score_s, cpu_fit_s=cpu_fit_s,
        experts_run=n_run, converged=n_conv, launches=launches, expected_block_chol=expected,
        f32_vs_cpu_f64=float(d[same].max()) if same.any() else None, compared=int(same.sum()),
        objectives_apart={int(e): [float(ref64["objective"][j]), float(f32_obj[j])]
                          for j, e in enumerate(ref64["expert_index"]) if not same[j]},
        bound=PRED_BOUND, rmse_rel_card_vs_cpu=rel, rmse_rel_bound=XVAL_RMSE_REL)
    check(n_conv >= MIN_SHARE * n_run, f"xval (c): only {n_conv}/{n_run} lanes converged")
    check(launches == {"block_chol": expected, "panel_chol": 0, "cholesky": 0, "mm3xtf32": 0}, f"xval (c) launches {launches}")
    check(same.sum() >= MIN_COMPARED_SHARE * len(pick),
          f"xval (c): the CPU f64 fit and the card's ended > 1 nat apart on {int((~same).sum())}/{len(pick)}")
    check(d[same].max() <= PRED_BOUND, f"xval (c): card f32 vs CPU f64 on {len(pick)} experts: {d}")
    check(all(np.isfinite(r["rmse_card_f32"]) and r["scored"] == r["held_out"] for r in rows),
          f"xval (c): fold scores {rows}")
    check(max(rel) <= XVAL_RMSE_REL, f"xval (c): fold RMSE card vs CPU f64, relative: {rel}")
    return launches["block_chol"]


def start_help_commands() -> list:
    """Phase 15 (d)'s two `--help` commands, started with the phase."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    return [subprocess.Popen([sys.executable, "-m", "gpsat_tpu_torch.cli", cmd, "--help"], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for cmd in ("xval", "prime_cache")]


def phase_xval(host_build_s):
    """Phase 15: (a) the host library's grid index on phase 7's geometry,
    (b) zarr stores of blosc chunks, (c) cross-validation on the card, (d)
    prime and the two commands' --help. Returns kernel 1's launches in (a)'s
    grid sweep and in (c)."""
    import tempfile

    from gpsat_tpu_torch.prime_cache import prime

    t_phase = time.perf_counter()
    procs = start_help_commands()
    try:
        launches_a = xval_index(host_build_s)
        a_s = time.perf_counter() - t_phase
        with tempfile.TemporaryDirectory() as out_dir:
            df, truth, store, experts = xval_stores(Path(out_dir))
            b_s = time.perf_counter() - t_phase - a_s
            launches_c = xval_run(df, truth, store, experts, Path(out_dir))
        c_s = time.perf_counter() - t_phase - a_s - b_s
        t0 = time.perf_counter()
        primed = prime(PRIME_SHAPES, model="gpr", verbose=False)
        prime_s = time.perf_counter() - t0
        helps = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()  # a no-op once it has ended
    for cmd, p, (out, err) in zip(("xval", "prime_cache"), procs, helps):
        check(p.returncode == 0 and "usage" in out, f"xval (d): {cmd} --help exited {p.returncode}: {err[-2000:]}")
    log("xval_prime", libraries_s=primed["libraries"],
        shapes={"x".join(map(str, k)): v for k, v in primed["shapes"].items()}, seconds=prime_s,
        help_exit_codes=[p.returncode for p in procs])
    check(all(v == 0.0 for v in primed["libraries"].values()), f"xval (d): prime rebuilt {primed['libraries']}")
    phase_s = time.perf_counter() - t_phase
    log("xval_phase", seconds=phase_s, budget_s=XVAL_BUDGET_S, a_s=a_s, b_s=b_s, c_s=c_s, d_s=prime_s)
    return launches_a, launches_c


def vds_granules(n: int):
    """(file name, first row, end row) of each of phase 17 (i)'s granule
    files over ``n`` observation rows."""
    bounds = np.linspace(0, n, FORMATS_VDS_GRANULES + 1).astype(int)
    return [(f"vds_obs_granule_{i:02d}.nc", int(bounds[i]), int(bounds[i + 1])) for i in range(FORMATS_VDS_GRANULES)]


def vds_files(root: Path) -> Path:
    """Phase 7's observations as phase 17 (i) reads them: the granules of
    ``vds_granules`` written by DataLoader.write_to_netcdf (the port's
    writer), the virtual fixture beside them. Its path."""
    import shutil

    import pandas as pd

    from gpsat_tpu_torch.dataloader import DataLoader

    frame = pd.DataFrame(pipeline_inputs()[0])
    for name, lo, hi in vds_granules(len(frame)):
        DataLoader.write_to_netcdf(frame.iloc[lo:hi], str(root / name))
    return Path(shutil.copy(FORMATS_DIR / FORMATS_VDS, root / FORMATS_VDS))


def cli_inputs(root: Path, obs_format: str = "h5"):
    """Phase 7's inputs as the workflow's files: the observations as a .h5
    store (table "data", the port's TableStore), with ``obs_format`` "nc"
    as one netCDF file (DataLoader.write_to_netcdf), with "vds" as the
    virtual netCDF file over granule files (``vds_files``), the expert and
    prediction locations as CSV, and a local_expert_oi config with phase
    7's model settings whose results store is results.h5 beside them.
    Returns the config's path and phase 7's expert locations."""
    import pandas as pd

    from gpsat_tpu_torch.data.store import TableStore
    from gpsat_tpu_torch.dataloader import DataLoader

    obs, experts, grid = pipeline_inputs()
    if obs_format == "nc":
        DataLoader.write_to_netcdf(pd.DataFrame(obs), str(root / "obs.nc"))
        source = {"data_source": str(root / "obs.nc")}
    elif obs_format == "vds":
        source = {"data_source": str(vds_files(root))}
    else:
        with TableStore(str(root / "obs.h5"), mode="w") as s:
            s.append("data", pd.DataFrame(obs))
        source = {"data_source": str(root / "obs.h5"), "table": "data"}
    pd.DataFrame(experts).to_csv(root / "experts.csv", index=False)
    pd.DataFrame(grid).to_csv(root / "pred_locs.csv", index=False)
    cfg = {
        "comment": "chip_smoke phase 16: phase 7's pan-Arctic geometry through the workflow's files",
        "locations": {"source": str(root / "experts.csv")},
        "data": {**source, "obs_col": OI_KW["obs_col"], "coords_col": OI_KW["coords_col"],
                 "local_select": OI_KW["local_select"]},
        "model": {"oi_model": "GPflowGPRModel", "init_params": OI_KW["init_params"],
                  "constraints": OI_KW["constraints"], "optim_kwargs": OI_OPTIM},
        "pred_loc": {"method": "from_dataframe", "df_file": str(root / "pred_locs.csv"), "max_dist": OI_MAX_DIST},
        "run_kwargs": {"store_path": str(root / "results.h5"), "min_obs": OI_KW["min_obs"],
                       "pad_multiple": OI_KW["pad_multiple"]},
    }
    path = root / "oi.json"
    path.write_text(json.dumps(cfg))
    return path, experts


def cli_run(oi_polished, f32_it_max, root: Path, obs_format: str = "h5", tag: str = "cli_run",
            what: str = "cli (a)"):
    """(a) LocalExpertOI.run through `gpsat_tpu_torch.cli local_expert_oi`,
    held to phase 7's sweep; phase 17 (c) runs it on observations in a
    netCDF file (``obs_format`` "nc"), (i) in a virtual one ("vds").
    Returns kernel 1's launches, the results store's path and the bucket
    width."""
    import pandas as pd
    import torch

    from gpsat_tpu_torch import cli
    from gpsat_tpu_torch.data.store import TableStore
    from gpsat_tpu_torch.experts import get_phase_timers
    from gpsat_tpu_torch.parallel import batching

    cfg_path, experts = cli_inputs(root, obs_format)
    store = root / "results.h5"
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["local_expert_oi", str(cfg_path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    timers = get_phase_timers()
    t0 = time.perf_counter()
    with TableStore(str(store), mode="r") as s:
        tables = s.keys()
        rd = s.select("run_details", set_index=False)
        preds = s.select("preds", set_index=False)
    read_s = time.perf_counter() - t0
    ran = rd[rd["num_obs"] >= OI_KW["min_obs"]]
    nmax = batching.bucket_size(int(ran["num_obs"].max()))
    expected = {"block_chol": (f32_it_max + 2) * nmax // T, "panel_chol": 0, "cholesky": 0, "mm3xtf32": 0}
    ref = oi_polished["preds"]
    want_set = {(float(experts["x"][e]), float(experts["y"][e])) for e in oi_polished["converged"]}
    got_set = set(zip(ran["x"].astype(float), ran["y"].astype(float)))
    # the experts both runs' polish converged on, row by row
    both = ran[ran["optimise_success"].to_numpy()][["x", "y"]]
    conv7 = {(float(experts["x"][e]), float(experts["y"][e])) for e, c in oi_polished["converged"].items() if c}
    both = both[[(float(x), float(y)) in conv7 for x, y in both.to_numpy()]]
    keys = ["x", "y", "pred_loc_x", "pred_loc_y"]
    m = preds.merge(both, on=["x", "y"]).merge(ref.merge(both, on=["x", "y"]), on=keys, suffixes=("", "_oi"),
                                              how="outer", indicator=True)
    d = max(float(np.abs(m[c].to_numpy(np.float64) - m[f"{c}_oi"].to_numpy(np.float64)).max())
            for c in ("f*", "f*_var"))
    log(tag, rc=rc, experts=len(rd), run=len(ran), prediction_points=len(preds),
        phase7_prediction_points=len(ref), tables=tables, wall_s=wall, experts_per_s=len(ran) / wall,
        phases_s=timers, store_bytes=store.stat().st_size, read_back_s=read_s, converged=int(ran["optimise_success"].sum()),
        compared_experts=len(both), max_abs_vs_phase7=d, bound=CLI_SAME_BOUND, launches=launches)
    check(rc == 0, f"{what}: local_expert_oi returned {rc}")
    check(len(rd) == len(experts["x"]) and got_set == want_set,
          f"{what}: run_details has {len(rd)} experts, {len(got_set)} run, phase 7 ran {len(want_set)}")
    check(len(preds) == len(ref), f"{what}: {len(preds)} stored predictions, phase 7 made {len(ref)}")
    check(launches == expected, f"{what} launches {launches}, expected {expected}")
    check(len(both) >= MIN_SHARE * len(ran) and (m["_merge"] == "both").all(),
          f"{what}: {len(both)}/{len(ran)} experts converged in both runs, or their prediction rows differ")
    check(np.isfinite(preds[["f*", "f*_var"]].to_numpy()).all(), f"{what}: non-finite stored predictions")
    check(d <= CLI_SAME_BOUND, f"{what}: stored predictions vs phase 7's sweep: {d}")
    return launches["block_chol"], store, nmax


def cli_post(store: Path, nmax: int):
    """(b) `gpsat_tpu_torch.cli postprocessing` on (a)'s store with the
    flagship postprocessing config's smoothing, the predict-only re-run it
    writes, through `cli local_expert_oi`, and the glue of the re-run's
    stored predictions. Returns kernel 1's launches in the re-run."""
    import torch

    from gpsat_tpu_torch import cli
    from gpsat_tpu_torch.data.store import TableStore
    from gpsat_tpu_torch.experts import get_phase_timers, get_results_from_h5file
    from gpsat_tpu_torch.postprocess import SmoothingConfig, glue_local_predictions, smooth_table

    post = json.loads(SMOOTH_CONFIG.read_text())
    post["result_file"] = str(store)
    post_path = store.with_name("post.json")
    post_path.write_text(json.dumps(post))
    suffix = post["table_suffix"]
    t0 = time.perf_counter()
    rc = cli.main(["postprocessing", str(post_path)])
    smooth_s = time.perf_counter() - t0
    params = post["params_to_smooth"]
    dfs, cfgs = get_results_from_h5file(str(store), merge_on_expert_locations=False, select_tables=params)
    coords = cfgs[-1]["data"]["coords_col"]
    with TableStore(str(store), mode="r") as s:
        smoothed = {p: s.select(f"{p}{suffix}").reset_index() for p in params}
    d_smooth = 0.0
    for p in params:
        want = smooth_table(dfs[p].copy(), p, coords, ["x", "y"], SmoothingConfig(**post["smooth_config_dict"][p]))
        want = want.reset_index().sort_values([*coords, "_dim_0"]).reset_index(drop=True)
        got = smoothed[p].sort_values([*coords, "_dim_0"]).reset_index(drop=True)
        check(len(got) == len(want) and (got[coords].to_numpy() == want[coords].to_numpy()).all(),
              f"cli (b): {p}{suffix} rows differ from the in-memory smoothing's")
        d_smooth = max(d_smooth, float(np.abs(got[p].to_numpy() - want[p].to_numpy()).max()))

    rerun_cfg = store.with_name(f"{store.stem}{suffix}.json")
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    rc_re = cli.main(["local_expert_oi", str(rerun_cfg)])
    torch.cuda.synchronize()
    rerun_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    with TableStore(str(store), mode="r") as s:
        preds = s.select(f"preds{suffix}").reset_index()
        rd = s.select(f"run_details{suffix}", set_index=False)
    ran = rd[rd["num_obs"] >= OI_KW["min_obs"]]
    expected = {"block_chol": 2 * nmax // T, "panel_chol": 0, "cholesky": 0, "mm3xtf32": 0}
    finite = bool(np.isfinite(preds[["f*", "f*_var"]].to_numpy()).all())
    t0 = time.perf_counter()
    glued = glue_local_predictions(preds, inference_radius=GLUE_RADIUS, R=GLUE_R)
    glue_s = time.perf_counter() - t0
    keys = ["pred_loc_x", "pred_loc_y"]
    glued = glued.sort_values(keys).reset_index(drop=True)
    d_glue = 0.0
    for var in ("f*", "f*_var", "y_var", "f_bar"):
        locs, plain = glue_numpy(preds, GLUE_RADIUS, GLUE_R, var)
        check(np.array_equal(locs, glued[keys].to_numpy()), "cli (b): glued locations differ from the plain version's")
        d_glue = max(d_glue, float(np.abs(glued[var].to_numpy() - plain).max() / np.abs(plain).max()))
    log("cli_post", rc=rc, rerun_rc=rc_re, smooth_s=smooth_s, max_abs_smoothed_vs_in_memory=d_smooth,
        smooth_bound=CLI_SMOOTH_BOUND, rerun_s=rerun_s, rerun_phases_s=get_phase_timers(), rerun_experts=len(ran),
        rerun_prediction_points=len(preds), finite=finite, glue_s=glue_s, glued_locations=len(glued),
        max_rel_glue_vs_numpy=d_glue, glue_bound=GLUE_REL_BOUND, launches=launches)
    check(rc == 0 and rc_re == 0, f"cli (b): postprocessing returned {rc}, the re-run {rc_re}")
    check(d_smooth <= CLI_SMOOTH_BOUND, f"cli (b): stored smoothing vs in memory: {d_smooth}")
    check(len(ran) > 0 and finite and (ran["num_iter"] == 0).all(), "cli (b): re-run experts, iterations or finiteness")
    check(launches == expected, f"cli (b) re-run launches {launches}, expected {expected}")
    check(d_glue <= GLUE_REL_BOUND, f"cli (b): glue vs plain numpy: {d_glue}")
    return launches["block_chol"]


def along_track_frame():
    """STORE_ROWS along-track rows in eight columns (seed 0): phase 16 (c)'s
    table and phase 17 (b)'s files. Returns the frame, the seconds it took
    and its payload bytes (strings at their UTF-8 length)."""
    import pandas as pd

    rng = np.random.default_rng(0)
    n = STORE_ROWS
    sources = np.array([f"track_source_{i:02d}" for i in range(STORE_SOURCES)], dtype=object)
    t0 = time.perf_counter()
    frame = pd.DataFrame({
        "x": rng.uniform(-OI_EXTENT, OI_EXTENT, n), "y": rng.uniform(-OI_EXTENT, OI_EXTENT, n),
        "obs": rng.normal(0.3, 0.1, n), "elev": rng.normal(0.0, 1.0, n).astype(np.float32),
        "track": rng.integers(0, 1 << 40, n),
        "datetime": np.datetime64("2020-03-01", "ns") + np.sort(rng.integers(0, 30 * 86_400 * 10**9, n)).astype(
            "timedelta64[ns]"),
        "valid": rng.random(n) > 0.1,
    })
    frame["source"] = pd.Series(sources[rng.integers(0, STORE_SOURCES, n)], dtype=object)
    make_s = time.perf_counter() - t0
    payload = sum(frame[c].to_numpy().nbytes for c in frame.columns if c != "source") + int(
        frame["source"].str.len().sum())
    return frame, make_s, payload


def cli_store(root: Path):
    """(c) one table of STORE_ROWS along-track rows, eight columns, appended
    in STORE_BLOCKS blocks, read back whole and through a where on its
    datetime column; every column exact."""
    from gpsat_tpu_torch.data.store import TableStore

    frame, make_s, payload = along_track_frame()
    n = STORE_ROWS
    path = root / "along_track.h5"
    block = n // STORE_BLOCKS
    t0 = time.perf_counter()
    with TableStore(str(path), mode="w") as s:
        for b in range(STORE_BLOCKS):
            s.append("data", frame.iloc[b * block:(b + 1) * block])
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with TableStore(str(path), mode="r") as s:
        got = s.select("data")
    read_s = time.perf_counter() - t0
    where = {"col": "datetime", "comp": ">=", "val": "2020-03-15"}
    t0 = time.perf_counter()
    with TableStore(str(path), mode="r") as s:
        sub = s.select("data", where=[where])
    where_s = time.perf_counter() - t0
    mask = frame["datetime"].to_numpy() >= np.datetime64("2020-03-15")
    exact = {c: bool(np.array_equal(got[c].to_numpy(), frame[c].to_numpy())) for c in frame.columns}
    exact_where = {c: bool(np.array_equal(sub[c].to_numpy(), frame[c].to_numpy()[mask])) for c in frame.columns}
    log("cli_store", rows=len(got), blocks=STORE_BLOCKS, columns={c: str(frame[c].dtype) for c in frame.columns},
        payload_bytes=payload, file_bytes=path.stat().st_size, make_s=make_s, write_s=write_s,
        write_MBps=payload / write_s / 1e6, read_s=read_s, read_MBps=payload / read_s / 1e6, where_rows=len(sub),
        where_s=where_s, exact=exact, exact_where=exact_where)
    check(len(got) == n and all(exact.values()), f"cli (c): columns read back differ: {exact}")
    check(len(sub) == int(mask.sum()) and all(exact_where.values()), f"cli (c): the where's rows differ: {exact_where}")


def phase_cli(oi_polished, f32_it_max):
    """Phase 16: the flagship workflow through its normal entry points on
    the card, its stores through the port's own HDF5 codec: (a) local
    expert OI, (b) postprocessing, the predict-only re-run and the glue,
    (c) a store of 2,000,000 rows, (d) h5py never imported. Returns kernel
    1's launches in (a) and in (b)'s re-run."""
    import importlib.util
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        root = Path(tmp)
        launches_run, store, nmax = cli_run(oi_polished, f32_it_max, root)
        a_s = time.perf_counter() - t_phase
        launches_rerun = cli_post(store, nmax)
        b_s = time.perf_counter() - t_phase - a_s
        cli_store(root)
        c_s = time.perf_counter() - t_phase - a_s - b_s
    spec = importlib.util.find_spec("h5py")
    log("cli_h5py", find_spec=str(spec), loaded="h5py" in sys.modules)
    check("h5py" not in sys.modules, "cli (d): h5py was imported")
    log("cli_phase", seconds=time.perf_counter() - t_phase, budget_s=CLI_BUDGET_S, a_s=a_s, b_s=b_s, c_s=c_s)
    return launches_run, launches_rerun


def formats_expected(directory: Path = FORMATS_DIR):
    """tests/fixtures/hdf5/expected.npz: [(entry, arrays)] per expected
    frame; an entry names the file, the reader ("pytables" or "netcdf"),
    the table, and the columns and index levels (name, dtype, kind)."""
    with np.load(directory / "expected.npz", allow_pickle=False) as z:
        entries = json.loads(str(z["meta"]))
        arrays = {k: z[k] for k in z.files if k != "meta"}
    return [(e, {k.split("/", 1)[1]: v for k, v in arrays.items() if k.startswith(f"{i}/")})
            for i, e in enumerate(entries)]


def _same_values(got: np.ndarray, want: np.ndarray, kind: str) -> bool:
    if kind == "str":
        return got.dtype == object and len(got) == len(want) and bool(np.all(got.astype("U") == want))
    return got.dtype == want.dtype and np.array_equal(got, want, equal_nan=want.dtype.kind in "fcmM")


def frame_differences(df, entry: dict, arrays: dict) -> list:
    """How a frame differs from its expected entry: column names, dtypes
    and values, index names, dtypes and values, all exact (NaN and NaT equal
    themselves). Empty when they are the same."""
    out = []
    names = [c for c, _, _ in entry["columns"]]
    if [str(c) for c in df.columns] != names:
        return [f"columns {list(df.columns)} != {names}"]
    for j, (c, dtype, kind) in enumerate(entry["columns"]):
        if str(df[c].dtype) != dtype:
            out.append(f"column {c}: dtype {df[c].dtype} != {dtype}")
        elif not _same_values(df[c].to_numpy(), arrays[f"c{j}"], kind):
            out.append(f"column {c}: values differ")
    if df.index.nlevels != len(entry["index"]) or (df.index.nlevels > 1) != entry["multi"]:
        return out + [f"index of {df.index.nlevels} levels != {len(entry['index'])}"]
    for k, (name, dtype, kind) in enumerate(entry["index"]):
        vals = df.index.get_level_values(k).to_numpy()
        if df.index.names[k] != name or str(vals.dtype) != dtype or not _same_values(vals, arrays[f"i{k}"], kind):
            out.append(f"index level {k} ({name}) differs")
    return out


def region_frame(f, name: str):
    """Every element the region references in ``f[name]`` select, as a
    frame: per reference its index, the dataset it names (``f[ref]``), the
    selection's shape and each value (``dataset[ref]``, in order, as
    float64). ``f`` is an h5py File or the codec's."""
    import pandas as pd

    rows = {"ref": [], "dataset": [], "shape": [], "value": []}
    for i, ref in enumerate(f[name][()]):
        ds = f[ref]
        vals = np.asarray(ds[ref])
        rows["ref"] += [i] * vals.size
        rows["dataset"] += [ds.name] * vals.size
        rows["shape"] += ["x".join(map(str, vals.shape))] * vals.size
        rows["value"] += vals.astype(np.float64).reshape(-1).tolist()
    return pd.DataFrame({"ref": np.array(rows["ref"], np.int64), "dataset": np.array(rows["dataset"], object),
                         "shape": np.array(rows["shape"], object), "value": np.array(rows["value"], np.float64)})


def read_fixture(entry: dict, directory: Path = FORMATS_DIR):
    """An expected entry's frame as the port reads its file (from the
    fixtures' directory where the entry says "chdir": its external files'
    relative names lead there)."""
    import contextlib

    from gpsat_tpu_torch.data import hdf5
    from gpsat_tpu_torch.data import pytables_compat as PT
    from gpsat_tpu_torch.data.netcdf import read_netcdf

    path = str(directory / entry["file"])
    if entry["reader"] == "pytables":
        return PT.read_table(path, entry["key"])
    if entry["reader"] == "regions":
        with hdf5.File(path, "r") as f:
            return region_frame(f, entry["key"])
    if entry.get("chdir"):
        with contextlib.chdir(directory):
            return read_netcdf(entry["file"], variables=entry.get("variables"))
    return read_netcdf(path, variables=entry.get("variables"))


def formats_fixtures():
    """(a) every fixture of tests/fixtures/hdf5 through the port's readers,
    held to expected.npz exactly, with the seconds of each read."""
    seconds, bad = {}, {}
    for entry, arrays in formats_expected():
        label = f"{entry['file']}:{entry['key']}" if entry["key"] else entry["file"]
        t0 = time.perf_counter()
        df = read_fixture(entry)
        seconds[label] = time.perf_counter() - t0
        diff = frame_differences(df, entry, arrays)
        if diff:
            bad[label] = diff
    log("formats_fixtures", frames=len(seconds), seconds=seconds, total_s=sum(seconds.values()), differ=bad)
    check(not bad, f"formats (a): fixtures read differently from expected.npz: {bad}")


def formats_netcdf(root: Path):
    """(b) phase 16 (c)'s rows as FORMATS_FILES netCDF files written by
    DataLoader.write_to_netcdf, read back by `cli read_and_store` with the nc
    engine into a TableStore: every column exact, the datetimes by the CF
    decode's own rule (nanoseconds since the epoch through float64, as
    _decode_cf reads them in both packages); then read by read_netcdf
    alone. Write and read MB/s of the payload, and the read split: the
    same files read with decode_cf=False, and their variables read by the
    codec alone (each file opened, every dataset read whole)."""
    import pandas as pd

    from gpsat_tpu_torch import cli
    from gpsat_tpu_torch.data import hdf5
    from gpsat_tpu_torch.data.netcdf import read_netcdf
    from gpsat_tpu_torch.data.store import TableStore
    from gpsat_tpu_torch.dataloader import DataLoader

    frame, _, payload = along_track_frame()
    n, k = len(frame), FORMATS_FILES
    nc_dir = root / "nc"
    nc_dir.mkdir()
    bounds = np.linspace(0, n, k + 1).astype(int)
    t0 = time.perf_counter()
    for i in range(k):
        DataLoader.write_to_netcdf(frame.iloc[bounds[i]:bounds[i + 1]], str(nc_dir / f"along_track_{i:02d}.nc"))
    write_s = time.perf_counter() - t0
    files = sorted(nc_dir.iterdir())
    t0 = time.perf_counter()
    frames = [read_netcdf(str(p)) for p in files]
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for p in files:
        read_netcdf(str(p), decode_cf=False)
    raw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for p in files:
        with hdf5.File(str(p), "r") as f:
            for name in f.keys():
                f[name].read()
    codec_s = time.perf_counter() - t0
    cfg = {"output": {"file": str(root / "along_track_nc.h5"), "table": "data"}, "file_dirs": str(nc_dir),
           "file_regex": r"along_track_\d+\.nc", "read_engine": "nc"}
    (root / "read_and_store.json").write_text(json.dumps(cfg))
    t0 = time.perf_counter()
    rc = cli.main(["read_and_store", str(root / "read_and_store.json")])
    store_s = time.perf_counter() - t0
    with TableStore(cfg["output"]["file"], mode="r") as s:
        got = s.select("data", set_index=False)
    ns = frame["datetime"].to_numpy().astype(np.int64)
    cf = (pd.Timestamp("1970-01-01") + pd.to_timedelta(ns.astype(np.float64), unit="ns")).to_numpy()
    want = {**{c: frame[c].to_numpy() for c in frame.columns}, "datetime": cf, "index": np.arange(n)}
    exact = {c: bool(c in got.columns and np.array_equal(got[c].to_numpy(), v)) for c, v in want.items()}
    exact_read = all(np.array_equal(pd.concat(frames).reset_index()[c].to_numpy(), v) for c, v in want.items())
    log("formats_netcdf", rc=rc, rows=len(got), files=k, payload_bytes=payload,
        file_bytes=sum(p.stat().st_size for p in files), write_s=write_s, write_MBps=payload / write_s / 1e6,
        read_s=read_s, read_MBps=payload / read_s / 1e6, read_no_cf_decode_s=raw_s, codec_s=codec_s,
        cf_decode_s=read_s - raw_s, frame_build_s=raw_s - codec_s, read_and_store_s=store_s,
        read_and_store_MBps=payload / store_s / 1e6, exact=exact, exact_read_netcdf=exact_read,
        cf_datetime_max_abs_ns=int(np.abs(cf.astype(np.int64) - ns).max()))
    check(rc == 0, f"formats (b): read_and_store returned {rc}")
    check(len(got) == n and all(exact.values()) and exact_read, f"formats (b): columns read back differ: {exact}")


def formats_load_params(root: Path, fixture: str = "results_store.h5", tag: str = "formats_load_params"):
    """(d) load_params={"file": a PyTables results fixture} over phase 7's
    first FORMATS_EXPERTS experts, a predict-only run through `cli
    local_expert_oi`: the loaded init equals the fixture's values exactly,
    the stored parameters are within FORMATS_STORED_REL of them, and kernel
    1 launches 2 * Nmax / 64 times (one pair in the predict's bucket: phase
    16 (b)'s formula). Returns the launches and the stored parameter and
    prediction tables."""
    import pandas as pd
    import torch

    from gpsat_tpu_torch import cli
    from gpsat_tpu_torch.data import pytables_compat as PT
    from gpsat_tpu_torch.data.store import TableStore
    from gpsat_tpu_torch.experts import LocalExpertOI, core_for, initial_cparams
    from gpsat_tpu_torch.parallel import batching

    fixture = str(FORMATS_DIR / fixture)
    cfg_path, experts = cli_inputs(root)
    cfg = json.loads(cfg_path.read_text())
    locs = pd.DataFrame({c: experts[c][:FORMATS_EXPERTS] for c in ("x", "y")})
    locs.to_csv(root / "experts_64.csv", index=False)
    cfg["locations"] = {"source": str(root / "experts_64.csv")}
    cfg["model"]["load_params"] = {"file": fixture}
    cfg["run_kwargs"].update(store_path=str(root / "loaded.h5"), optimise=False)
    cfg_path = root / "load_params.json"
    cfg_path.write_text(json.dumps(cfg))
    want = {t: PT.read_table(fixture, t).reset_index() for t in ("lengthscales", "kernel_variance",
                                                                  "likelihood_variance")}
    ip, cons = OI_KW["init_params"], OI_KW["constraints"]
    core = core_for(ip, cons)
    oi = LocalExpertOI(model_config=cfg["model"])
    loaded = oi._load_params_for_experts(locs, ["x", "y"], initial_cparams(core, ip, cons, 2), core, None) or {}
    init_same = {}
    for p, w in want.items():  # the fixture's values in the experts' order
        w = w.sort_values(["x", "y", *(["_dim_0"] if p == "lengthscales" else [])], kind="stable")
        by_loc = {k: g[p].to_numpy() for k, g in w.groupby(["x", "y"], sort=False)}
        fixture_init = np.stack([by_loc[(x, y)] for x, y in locs[["x", "y"]].itertuples(index=False)])
        init_same[p] = p in loaded and bool(np.array_equal(loaded[p].reshape(len(locs), -1),
                                                           fixture_init.reshape(len(locs), -1)))
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["local_expert_oi", str(cfg_path)])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    stored_rel, stored_rows = {}, {}
    with TableStore(cfg["run_kwargs"]["store_path"], mode="r") as s:
        stored = {t: s.select(t) for t in ("preds", *want)}
        rd = s.select("run_details", set_index=False)
        ran = int((rd["num_obs"] >= OI_KW["min_obs"]).sum())
        for p, w in want.items():
            got = s.select(p).reset_index()
            keys = ["x", "y", *(["_dim_0"] if p == "lengthscales" else [])]
            m = got.merge(w, on=keys, suffixes=("", "_fixture"))
            fx = m[f"{p}_fixture"].to_numpy()
            stored_rows[p] = len(m) == ran * (2 if p == "lengthscales" else 1)
            stored_rel[p] = float(np.abs(m[p].to_numpy(np.float64) - fx).max() / np.abs(fx).max()) if len(m) else None
    nmax = batching.bucket_size(int(rd.loc[rd["num_obs"] >= OI_KW["min_obs"], "num_obs"].max()))
    expected = {"block_chol": 2 * nmax // T, "panel_chol": 0, "cholesky": 0, "mm3xtf32": 0}
    log(tag, fixture=Path(fixture).name, rc=rc, experts=len(rd), run=int((rd["num_obs"] >= OI_KW["min_obs"]).sum()),
        iterations=int(rd["num_iter"].max()), run_s=run_s, init_equals_fixture=init_same,
        stored_rel_vs_fixture=stored_rel, stored_bound=FORMATS_STORED_REL, launches=launches, expected=expected)
    what = f"formats (d) {Path(fixture).name}"
    check(rc == 0 and len(rd) == FORMATS_EXPERTS, f"{what}: local_expert_oi returned {rc}, {len(rd)} experts")
    check(init_same and all(init_same.values()), f"{what}: loaded init vs the fixture: {init_same}")
    check(all(stored_rows.values()) and all(r is not None and r <= FORMATS_STORED_REL for r in stored_rel.values())
          and (rd["num_iter"] == 0).all(), f"{what}: stored parameters vs the fixture: {stored_rel} {stored_rows}")
    check(launches == expected, f"{what} launches {launches}, expected {expected}")
    return launches["block_chol"], stored


def _table_max_abs_diff(got, want):
    """The largest absolute difference of two frames' numeric columns (NaN
    where both are NaN counts as equal), or None where their index,
    columns, NaN positions or other columns differ."""
    if not (got.index.equals(want.index) and list(got.columns) == list(want.columns)):
        return None
    num = list(want.select_dtypes("number").columns)
    rest = [c for c in want.columns if c not in num]
    if rest and not got[rest].equals(want[rest]):
        return None
    g, w = got[num].to_numpy(np.float64), want[num].to_numpy(np.float64)
    if not np.array_equal(np.isnan(g), np.isnan(w)):
        return None
    both = ~np.isnan(w)
    return float(np.abs(g[both] - w[both]).max()) if both.any() else 0.0


def formats_load_params_v4(root: Path, launches_v18: int, stored_v18: dict):
    """(d) again from the version-4 copy of the results fixture (extensible
    array chunk indexes): kernel 1 launches as often as from the v1.8 file,
    and the stored parameters and predictions equal that run's exactly."""
    launches, stored = formats_load_params(root, FORMATS_V4_RESULTS, tag="formats_load_params_v4")
    diff = {t: _table_max_abs_diff(stored[t], want) for t, want in stored_v18.items()}
    log("formats_load_params_v4_vs_v18", launches_v4=launches, launches_v18=launches_v18, max_abs_diff=diff)
    check(launches == launches_v18, f"formats (d) v4: kernel 1 launched {launches} times, {launches_v18} from v1.8")
    check(all(d == 0.0 for d in diff.values()), f"formats (d) v4: stored tables differ from the v1.8 run: {diff}")
    return launches


def formats_lzf():
    """(f) h5py's lzf filter: every lzf chunk of FORMATS_DIR's lzf fixture
    decoded by the host library's C++ loop and by the plain Python one,
    equal byte for byte (and the raw chunk passed through, its mask bit
    set); the MB/s of each over the decoded bytes, every chunk decoded
    FORMATS_LZF_REPS times (its chunks are of 1 KB)."""
    from gpsat_tpu_torch.data import hdf5
    from gpsat_tpu_torch.data.lzf import lzf_decode

    seconds, decoded, chunks, raw_chunks, bad = {"native": 0.0, "python": 0.0}, 0, 0, 0, []
    with hdf5.File(str(FORMATS_DIR / FORMATS_LZF), "r") as f:
        for name in ("z", "u"):
            ds = f[name]
            n = int(np.prod(ds.chunks)) * ds.dtype.itemsize
            _, addrs, sizes, masks = ds._chunk_index()
            for a, size, mask in zip(addrs.tolist(), sizes.tolist(), masks.tolist()):
                blob = f._read(a, size)
                if mask & 1:
                    raw_chunks += 1
                    continue
                out = {}
                for decoder in ("native", "python"):
                    t0 = time.perf_counter()
                    for _ in range(FORMATS_LZF_REPS):
                        out[decoder] = lzf_decode(blob, n, decoder=decoder)
                    seconds[decoder] += time.perf_counter() - t0
                chunks += 1
                decoded += len(out["native"])
                if out["native"] != out["python"] or len(out["native"]) != n:
                    bad.append((name, a))
    log("formats_lzf", chunks=chunks, raw_chunks=raw_chunks, decoded_bytes=decoded, reps=FORMATS_LZF_REPS,
        seconds=seconds, native_MBps=FORMATS_LZF_REPS * decoded / seconds["native"] / 1e6,
        python_MBps=FORMATS_LZF_REPS * decoded / seconds["python"] / 1e6, differ=bad)
    check(chunks > 0 and raw_chunks == 1 and not bad, f"formats (f): lzf decoders differ on {bad} "
          f"({chunks} chunks, {raw_chunks} stored raw)")


def restart_oi(store_path, device, first_half: bool = False):
    """(h)'s run: LocalExpertOI.run with phase 7's data, model settings and
    prediction grid over phase 7's experts FORMATS_RESTART_EXPERTS, into
    ``store_path`` on ``device``; the frames are the config's own, so a
    restart matches its stored config. ``first_half``: only the first half
    of the experts' results are kept (the fixture's stores). Returns the
    run's wall seconds."""
    import pandas as pd

    from gpsat_tpu_torch.experts import LocalExpertOI

    obs, experts, grid = pipeline_inputs()
    locs = pd.DataFrame({c: experts[c][FORMATS_RESTART_EXPERTS] for c in ("x", "y")})
    oi = LocalExpertOI(
        expert_loc_config={"source": locs},
        data_config={"data_source": pd.DataFrame(obs), "obs_col": OI_KW["obs_col"], "coords_col": OI_KW["coords_col"],
                     "local_select": OI_KW["local_select"]},
        model_config={"oi_model": "GPflowGPRModel", "init_params": OI_KW["init_params"],
                      "constraints": OI_KW["constraints"], "optim_kwargs": OI_OPTIM},
        pred_loc_config={"method": "from_dataframe", "df": pd.DataFrame(grid), "max_dist": OI_MAX_DIST})
    t0 = time.perf_counter()
    oi.run(store_path=str(store_path), min_obs=OI_KW["min_obs"], pad_multiple=OI_KW["pad_multiple"], device=device)
    return time.perf_counter() - t0


def formats_restart(root: Path):
    """(h) LocalExpertOI.run restarts into a copy of each of
    FORMATS_RESTART_STORES, which h5py wrote (superblock 3: version-2
    headers, new-style groups, extensible-array chunk indexes, deflate and
    shuffle; superblock 2: version-3 layouts, the chunk K in the superblock
    extension), and into the codec's own superblock-0 copy of each (every
    table read and written anew by TableStore): the stored rows stay as they
    were, exactly; the new rows are 0.0 from the copy's (run_time, the wall
    clock, aside) and kernel 1 launches as often in both. Then
    FORMATS_APPEND_ROWS of the predictions' rows appended to each store in
    FORMATS_APPEND_BLOCKS appends, read back exactly: the MB/s into its
    deflate+shuffle columns and into unfiltered ones. Returns kernel 1's
    launches in the restarts."""
    import shutil

    import torch

    from gpsat_tpu_torch.data import hdf5
    from gpsat_tpu_torch.data.store import TableStore

    def tables(path):
        with TableStore(str(path), mode="r") as s:
            return {t: s.select(t, set_index=False) for t in s.keys()}

    report, launches_all, append_mbps = {}, [], {}
    for name in FORMATS_RESTART_STORES:
        store, copy = root / name, root / f"sb0_{name}"
        shutil.copy(FORMATS_DIR / name, store)
        with hdf5.File(str(store), "r") as f:
            superblock = f.superblock_version
        before = tables(store)
        with TableStore(str(FORMATS_DIR / name), mode="r") as s, TableStore(str(copy), mode="w") as out:
            for t in s.keys():
                out.append(t, s.select(t))
        wall, launches, after = {}, {}, {}
        for tag, path in (("h5py", store), ("sb0", copy)):
            torch.cuda.synchronize()
            for fn in counters().values():
                fn.launches = 0
            wall[tag] = restart_oi(path, None)
            torch.cuda.synchronize()
            launches[tag] = {k: fn.launches for k, fn in counters().items()}
            after[tag] = tables(path)
        with hdf5.File(str(store), "r") as f:
            kept_superblock = f.superblock_version == superblock
        stored_same = {t: after["h5py"][t].iloc[:len(df)].equals(df) for t, df in before.items()}
        new_rows = {t: len(after["h5py"][t]) - len(df) for t, df in before.items()}
        diff = {}
        for t, df in after["sb0"].items():
            got, want = (x.iloc[len(before[t]):].drop(columns=["run_time"], errors="ignore").reset_index(drop=True)
                         for x in (after["h5py"][t], df))
            diff[t] = _table_max_abs_diff(got, want) if len(want) or len(got) else 0.0
        # the rows appended to the predictions: its own rows, tiled
        preds = after["h5py"]["preds"]
        block = preds.iloc[np.arange(FORMATS_APPEND_ROWS // FORMATS_APPEND_BLOCKS) % len(preds)].reset_index(drop=True)
        nbytes = FORMATS_APPEND_ROWS // FORMATS_APPEND_BLOCKS * FORMATS_APPEND_BLOCKS * sum(
            block[c].to_numpy().dtype.itemsize for c in block.columns)
        t0 = time.perf_counter()
        with TableStore(str(store), mode="a") as s:
            for _ in range(FORMATS_APPEND_BLOCKS):
                s.append("preds", block)
        append_s = time.perf_counter() - t0
        grown = tables(store)["preds"]
        appended_same = grown.iloc[:len(preds)].equals(preds) and all(
            grown.iloc[len(preds) + k * len(block):len(preds) + (k + 1) * len(block)].reset_index(drop=True).equals(block)
            for k in range(FORMATS_APPEND_BLOCKS))
        with hdf5.File(str(store), "r") as f:
            filters = sorted({flt.label() for c in f["preds"].keys() for flt in f["preds"][c]._filters})
        append_mbps[name] = nbytes / append_s / 1e6
        report[name] = dict(superblock=superblock, kept_superblock=kept_superblock, restart_s=wall["h5py"],
                            restart_sb0_s=wall["sb0"], h5py_over_sb0=wall["h5py"] / wall["sb0"], new_rows=new_rows,
                            stored_rows_same=stored_same, max_abs_diff_vs_sb0=diff, launches=launches,
                            append_rows=FORMATS_APPEND_ROWS, append_bytes=nbytes, append_s=append_s,
                            append_MBps=append_mbps[name], append_filters=filters, appended_same=appended_same)
        what = f"formats (h) {name}"
        check(kept_superblock and all(stored_same.values()), f"{what}: stored rows changed: {stored_same}")
        check(new_rows["run_details"] > 0 and all(d == 0.0 for d in diff.values()),
              f"{what}: the restart's new rows vs the superblock-0 copy's: {diff} ({new_rows})")
        check(launches["h5py"] == launches["sb0"] and launches["h5py"]["block_chol"] > 0,
              f"{what}: launches {launches}")
        check(appended_same, f"{what}: the appended predictions read back differently")
        launches_all.append(launches["h5py"]["block_chol"])
    log("formats_restart", stores=report, append_MBps=append_mbps)
    return sum(launches_all)


def formats_throughput(root: Path):
    """(g) reported, not checked: reading the largest version-4 fixture
    (every dataset, through the codec) beside reading the same rows written
    by the codec under the v1.8 layout (a version-1 B-tree over chunks of
    the same rows; contiguous data contiguous). For each file, medians of
    FORMATS_READ_REPS repeats: opening it (the headers), walking the chunk
    index of each chunked dataset, reading every dataset. Then the
    checksum's share of the version-4 read: every structure whose lookup3
    that read checks, hashed by the host library's C++ loop and by the
    plain Python one (equal, checked), and the read timed again with the
    Python one checking them."""
    import statistics
    from unittest import mock

    from gpsat_tpu_torch import native
    from gpsat_tpu_torch.data import hdf5, hdf5_structures

    largest = max(FORMATS_DIR.glob("v4_*"), key=lambda p: p.stat().st_size)
    copy = root / "v18_copy.h5"
    with hdf5.File(str(largest), "r") as f, hdf5.File(str(copy), "w") as out:
        names = [k for k in f.keys() if isinstance(f[k], hdf5.Dataset)]
        chunked = [k for k in names if f[k].chunks]
        for k in names:
            ds = f[k]
            if ds.chunks and ds.ndim == 1:
                out.create_dataset(k, ds[()], chunk_rows=ds.chunks[0])
            else:
                out.create_dataset(k, ds[()], contiguous=True)

    def median_s(fn):
        fn()
        seconds = []
        for _ in range(FORMATS_READ_REPS):
            t0 = time.perf_counter()
            fn()
            seconds.append(time.perf_counter() - t0)
        return statistics.median(seconds)

    def opened(path):
        with hdf5.File(str(path), "r") as f:
            return [f[k].shape for k in names]

    def walked(path):
        with hdf5.File(str(path), "r") as f:
            return [f[k]._chunk_index() for k in chunked]

    def read(path):
        with hdf5.File(str(path), "r") as f:
            return sum(f[k][()].nbytes for k in names)

    n4, n18 = read(largest), read(copy)
    layouts = {}
    for tag, path in (("v4", largest), ("v18", copy)):
        layouts[tag] = {"open_s": median_s(lambda: opened(path)), "index_s": median_s(lambda: walked(path)),
                        "read_s": median_s(lambda: read(path)), "file_bytes": path.stat().st_size}
        layouts[tag]["MBps"] = n4 / layouts[tag]["read_s"] / 1e6

    seen, checked = [], hdf5_structures.checksum

    def recording(data):
        seen.append(bytes(data))
        return checked(data)

    with mock.patch.object(hdf5_structures, "checksum", recording):
        read(largest)
    lookup3_s = {"native": median_s(lambda: [native.lookup3(b) for b in seen]),
                 "python": median_s(lambda: [hdf5_structures.lookup3(b) for b in seen])}
    with mock.patch.object(hdf5_structures, "checksum", hdf5_structures.lookup3):
        read_python_s = median_s(lambda: read(largest))
    differ = sum(native.lookup3(b) != hdf5_structures.lookup3(b) for b in seen)
    log("formats_throughput", file=largest.name, datasets=names, chunked=chunked, payload_bytes=n4,
        reps=FORMATS_READ_REPS, v4=layouts["v4"], v18=layouts["v18"],
        v4_over_v18_read=layouts["v4"]["read_s"] / layouts["v18"]["read_s"],
        checksummed={"structures": len(seen), "bytes": sum(map(len, seen))}, lookup3_s=lookup3_s,
        v4_read_s={"native": layouts["v4"]["read_s"], "python": read_python_s},
        python_lookup3_share=lookup3_s["python"] / read_python_s, lookup3_differ=differ)
    check(n4 == n18, f"formats (g): {n4} bytes read from {largest.name}, {n18} from its v1.8 copy")
    check(seen and not differ, f"formats (g): lookup3 in C++ and in Python differ on {differ} of "
          f"{len(seen)} structures")


def formats_virtual_read(root: Path):
    """(i), after the run: the virtual file's rows (read_netcdf through the
    codec, each of the four variables gathered from the granules) equal
    the same rows written to one file by DataLoader.write_to_netcdf and
    read back, and phase 7's observation rows, exactly; the medians of
    FORMATS_READ_REPS reads of each, seconds and MB/s of the payload."""
    import statistics

    import pandas as pd

    from gpsat_tpu_torch.data.netcdf import read_netcdf
    from gpsat_tpu_torch.dataloader import DataLoader

    obs = pipeline_inputs()[0]
    frame = pd.DataFrame(obs)
    direct = root / "obs_direct.nc"
    DataLoader.write_to_netcdf(frame, str(direct))
    vds = root / FORMATS_VDS

    def median_s(path):
        seconds = []
        for _ in range(FORMATS_READ_REPS):
            t0 = time.perf_counter()
            read_netcdf(str(path))
            seconds.append(time.perf_counter() - t0)
        return statistics.median(seconds)

    got, want = read_netcdf(str(vds)), read_netcdf(str(direct))
    rows = {"index": np.arange(len(frame)), **{c: np.asarray(v) for c, v in obs.items()}}
    flat = got.reset_index()
    exact = {c: bool(c in flat and flat[c].dtype == v.dtype and np.array_equal(flat[c].to_numpy(), v))
             for c, v in rows.items()}
    same = bool(got.equals(want) and list(got.columns) == list(want.columns) and got.index.equals(want.index))
    payload = sum(v.nbytes for v in rows.values())
    vds_s, direct_s = median_s(vds), median_s(direct)
    log("formats_vds_read", rows=len(got), granules=FORMATS_VDS_GRANULES, payload_bytes=payload, exact=exact,
        same_as_one_file=same, reps=FORMATS_READ_REPS, vds_read_s=vds_s, vds_MBps=payload / vds_s / 1e6,
        one_file_read_s=direct_s, one_file_MBps=payload / direct_s / 1e6, vds_over_one_file=vds_s / direct_s)
    check(all(exact.values()) and same, f"formats (i): the virtual file's rows differ: exact {exact}, "
          f"same as one file {same}")


def phase_formats(oi_polished, f32_it_max):
    """Phase 17: the readers' formats on the card's machine, with no h5py:
    (a) the HDF5 fixtures against expected.npz (version-4 layouts, lzf,
    committed datatypes and a user block among them), (b) netCDF files
    through DataLoader.write_to_netcdf and `cli read_and_store`, (c) phase
    7 from a netCDF observations file through `cli local_expert_oi`, (d)
    load_params from a PyTables results store, and from its version-4 copy,
    (e) h5py never imported, (f) the lzf decoders, C++ and Python, (g) the
    largest version-4 fixture's open, index walk and read beside its rows'
    under v1.8, and lookup3's share of its read, C++ against Python, (h)
    restarts into stores h5py wrote, (i) phase 7 from a virtual netCDF
    file over granule files through `cli local_expert_oi`. Returns kernel
    1's launches in (c), (d), (d)'s version-4 run, (h) and (i)."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_formats_") as tmp:
        root = Path(tmp)
        formats_fixtures()
        a_s = time.perf_counter() - t_phase
        formats_netcdf(root)
        b_s = time.perf_counter() - t_phase - a_s
        (root / "oi").mkdir()
        launches_oi, _, _ = cli_run(oi_polished, f32_it_max, root / "oi", obs_format="nc", tag="formats_oi",
                                       what="formats (c)")
        c_s = time.perf_counter() - t_phase - a_s - b_s
        (root / "load").mkdir()
        launches_load, stored = formats_load_params(root / "load")
        (root / "load_v4").mkdir()
        launches_load_v4 = formats_load_params_v4(root / "load_v4", launches_load, stored)
        d_s = time.perf_counter() - t_phase - a_s - b_s - c_s
        formats_lzf()
        formats_throughput(root)
        fg_s = time.perf_counter() - t_phase - a_s - b_s - c_s - d_s
        (root / "restart").mkdir()
        launches_restart = formats_restart(root / "restart")
        h_s = time.perf_counter() - t_phase - a_s - b_s - c_s - d_s - fg_s
        (root / "vds").mkdir()
        launches_vds, _, _ = cli_run(oi_polished, f32_it_max, root / "vds", obs_format="vds", tag="formats_vds",
                                     what="formats (i)")
        formats_virtual_read(root / "vds")
        i_s = time.perf_counter() - t_phase - a_s - b_s - c_s - d_s - fg_s - h_s
    log("formats_h5py", loaded="h5py" in sys.modules)
    check("h5py" not in sys.modules, "formats (e): h5py was imported")
    seconds = time.perf_counter() - t_phase
    log("formats_phase", seconds=seconds, budget_s=FORMATS_BUDGET_S, a_s=a_s, b_s=b_s, c_s=c_s, d_s=d_s, fg_s=fg_s,
        h_s=h_s, i_s=i_s)
    check(seconds <= FORMATS_BUDGET_S, f"formats: phase 17 took {seconds:.1f} s, over {FORMATS_BUDGET_S} s")
    return launches_oi, launches_load, launches_load_v4, launches_restart, launches_vds


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (ROOT / "gpsat_tpu_torch").is_dir():
        print(f"chip_smoke: no gpsat_tpu_torch package in {ROOT}: run the script from a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from concurrent.futures import ThreadPoolExecutor

    from gpsat_tpu_torch.ops import _build
    from gpsat_tpu_torch.ops import block_chol as BC
    from gpsat_tpu_torch.ops import cholesky as CH
    from gpsat_tpu_torch.ops import mm3xtf32 as MM
    from gpsat_tpu_torch.ops import panel_chol as PC

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("device", card=card, torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])

    def build_host():
        t = time.perf_counter()
        return _build.build_host_library(HOST_LIBRARY), time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:  # one nvcc per source and the g++, all started together
        host = pool.submit(build_host)
        libs = list(pool.map(_build.build_library, KERNELS))
        host_lib, host_build_s = host.result()
    log("build", seconds=time.perf_counter() - t0, libraries=[str(lib.relative_to(ROOT)) for lib in libs],
        host_library=str(host_lib.relative_to(ROOT)), host_build_s=host_build_s)
    for lib in libs:
        print(Path(str(lib) + ".log").read_text().strip(), flush=True)

    profile = "--profile" in argv
    entries = [phase_kernel(BC), phase_kernel_panel(PC), phase_kernel_cholesky(CH, profile), phase_kernel_mm3xtf32(MM)]
    if "--kernels" in argv:
        return 0
    batch, init = bench_workload()
    main_res, entries[0]["launches"] = phase_main(batch, init, profile)
    phase_f64(*phase_accuracy(batch, init))
    entries[1]["launches"] = phase_panel(batch, init, main_res, profile)
    entries[2]["launches"], _ = phase_profiled(batch, init, profile)
    entries[0]["launches_oi"], f32_oi, f32_it_max, oi_polished = phase_oi(profile)
    entries[0]["launches_post_fit"], entries[0]["launches_post_repredict"] = phase_post(f32_oi, f32_it_max, profile)
    (entries[0]["launches_sgpr_full"], entries[0]["launches_sgpr_chunked"], entries[0]["launches_sgpr_chunked_high"],
     entries[0]["launches_sgpr_replace"], entries[3]["launches"]) = phase_sgpr(profile)
    (entries[0]["launches_svgp_collapsed"], entries[0]["launches_svgp_bernoulli"],
     entries[0]["launches_svgp_adam_natgrad"], entries[0]["launches_svgp_config"]) = phase_svgp(profile)
    entries[0]["launches_zoo_vff"], entries[0]["launches_zoo_asvgp"] = phase_zoo(profile)
    for tag, n in phase_host().items():
        entries[0][f"launches_host_{tag}"] = n
    entries[2]["launches_prep_profiled_rq"], prep_block = phase_prep(batch, init, profile)
    for tag, n in prep_block.items():
        entries[0][f"launches_{tag}"] = n
    (entries[0]["launches_mesh_default"], entries[0]["launches_mesh_two_shards"],
     entries[0]["launches_mesh_processes"]) = phase_mesh(f32_oi)
    entries[0]["launches_xval_index_grid"], entries[0]["launches_xval"] = phase_xval(host_build_s)
    entries[0]["launches_cli_run"], entries[0]["launches_cli_rerun"] = phase_cli(oi_polished, f32_it_max)
    (entries[0]["launches_formats_oi"], entries[0]["launches_formats_load_params"],
     entries[0]["launches_formats_load_params_v4"], entries[0]["launches_formats_restart"],
     entries[0]["launches_formats_vds"]) = phase_formats(oi_polished, f32_it_max)

    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
