"""The port's C++ host library (gpsat_tpu_torch/native.py, built by g++ from
gpsat_tpu_torch/csrc/host/gpsat_native.cpp) against its plain versions and
the JAX package's host functions, on the CPU: the grid-hash radius index
and the masks on binned data with points exactly on the radius, the
weights and inverse transforms, the blosc codec loops, the handle-based
index from two threads, the sweep's selection on both arms, and a failed
build raising. Everything compared is host code in both packages: no JAX
program is compiled."""

import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from gpsat_tpu import native as jax_native
from gpsat_tpu.data import blosc as JB
from gpsat_tpu.data import prediction_locations as JPL
from gpsat_tpu.data import select as JSEL
from gpsat_tpu.utils import inverse_sigmoid as jax_inverse_sigmoid
from gpsat_tpu_torch import native
from gpsat_tpu_torch.data import blosc as TB
from gpsat_tpu_torch.data import prediction_locations as TPL
from gpsat_tpu_torch.data import select as TSEL
from gpsat_tpu_torch.ops import _build
from gpsat_tpu_torch.ops import transforms as TT
from gpsat_tpu_torch.postprocess import gaussian_2d_weight as torch_gaussian_2d_weight

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "blosc"
# the weights and transforms: the same f64 formula in another order
REL_BOUND = 1e-14


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def binned(seed=0, n_cells=60, bin_w=50.0, keep=0.55):
    """Cell centres of a 50-unit grid with ~55 % occupancy, and experts on
    the 200-unit grid: every radius below is a multiple of the bin width,
    so points sit exactly on the radius (distances 150, 200, 250 = 3-4-5)."""
    rng = np.random.default_rng(seed)
    c = (np.arange(n_cells) + 0.5) * bin_w
    X, Y = np.meshgrid(c, c)
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    pts = pts[rng.uniform(size=len(pts)) < keep]
    e = (np.arange(0, n_cells, 4) + 0.5) * bin_w
    EX, EY = np.meshgrid(e, e)
    return pts, np.stack([EX.ravel(), EY.ravel()], axis=1)


@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("radius", [150.0, 250.0])
def test_radius_query_all_grid_kdtree_and_jax_equal(inclusive, radius):
    # equal index sets (sorted) on both boundary rules; the boundary is
    # populated, so the two rules differ
    pts, experts = binned()
    grid = native.radius_query_all(pts, experts, radius, inclusive=inclusive, index="grid")
    kd = native.radius_query_all(pts, experts, radius, inclusive=inclusive, index="kdtree")
    jax = [np.sort(ix) for ix in jax_native.radius_query_all(pts, experts, radius, inclusive=inclusive)]
    assert len(grid) == len(kd) == len(jax) == len(experts)
    for g, k, j in zip(grid, kd, jax):
        np.testing.assert_array_equal(g, k)
        np.testing.assert_array_equal(g, j)
    other = native.radius_query_all(pts, experts, radius, inclusive=not inclusive)
    on_edge = sum(len(a) - len(b) for a, b in zip(grid, other)) * (1 if inclusive else -1)
    assert on_edge > 0, "no point on the radius: the boundary rule is untested"


def test_select_and_prediction_locations_on_both_arms_match_jax():
    # the sweep's two radius queries, the JAX package's functions and the
    # port's grid and kdtree arms: equal index sets and prediction rows
    pts, experts = binned(seed=1)
    df = {"x": pts[:, 0], "y": pts[:, 1], "t": np.arange(len(pts)) % 7}
    ref = {"x": experts[:, 0], "y": experts[:, 1], "t": np.full(len(experts), 3)}
    ls = [{"col": ["x", "y"], "comp": "<", "val": 200.0}, {"col": "t", "comp": ">=", "val": -1}]
    import pandas as pd

    want = JSEL.local_select_indices_all(pd.DataFrame(df), pd.DataFrame(ref), ls)
    for index in ("grid", "kdtree"):
        got = TSEL.local_select_indices_all(df, ref, ls, index=index)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    grid_df = {"x": pts[:, 0].copy(), "y": pts[:, 1].copy()}
    jpl = JPL.PredictionLocations("from_dataframe", coords_col=["x", "y"], df=pd.DataFrame(grid_df), max_dist=150.0)
    want = jpl.batch_call(pd.DataFrame(ref))
    for index in ("grid", "kdtree"):
        tpl = TPL.PredictionLocations("from_dataframe", coords_col=["x", "y"], df=grid_df, max_dist=150.0, index=index)
        got = tpl.batch_call(ref)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        # the per-expert path (max_dist_bool) gives the batched rows
        tpl.expert_loc = experts[5:6]
        np.testing.assert_array_equal(tpl(), got[5])


def test_max_dist_bool_equal_to_numpy_and_jax():
    pts, experts = binned(seed=2)
    pts3 = np.concatenate([pts, np.round(pts[:, :1] / 3)], axis=1)
    for locs, ref in ((pts, experts[7]), (pts3, pts3[100])):
        got = native.max_dist_bool(locs, ref, 150.0)
        np.testing.assert_array_equal(got, TPL.max_dist_bool(locs, ref, 150.0))
        np.testing.assert_array_equal(got, JPL.max_dist_bool(locs, ref, 150.0))
        assert got.sum() > 0


def test_weights_and_inverse_transforms_within_1e_14():
    rng = np.random.default_rng(3)
    x, y = rng.uniform(-5, 5, 300), rng.uniform(-5, 5, 300)
    vals = rng.normal(size=300)
    vals[::13] = np.nan
    x0, y0 = rng.uniform(-6, 6, 50), rng.uniform(-6, 6, 50)
    x0[0] = 1e6  # every weight underflows: NaN, as the plain version
    got = native.gaussian_2d_weight(x0, y0, x, y, 1.5, 0.7, vals)
    want = torch_gaussian_2d_weight(x0, y0, x, y, 1.5, 0.7, vals, device="cpu")
    assert np.isnan(got[0]) and np.isnan(want[0])
    # relative to the largest value: a weighted mean near 0 cancels
    np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=REL_BOUND * np.abs(want[1:]).max())

    y_sp = np.concatenate([[-1.0, 0.0, 1e-300, 1e-20], rng.uniform(1e-6, 50, 200), [40.0, 1e5]])
    got = native.inverse_softplus(y_sp)
    want = TT.inverse_softplus(torch.as_tensor(y_sp)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=REL_BOUND, atol=0)
    # a shift of 0.5 rounds y + 0.5 - 0.5: held where y keeps its digits
    keep = fin & (y_sp > 1e-3)
    np.testing.assert_allclose(native.inverse_softplus(y_sp + 0.5, shift=0.5)[keep], want[keep], rtol=1e-9, atol=0)

    y_sg = np.concatenate([[0.1, 2.0, 3.0, 5.0], rng.uniform(2.0, 3.0, 200)])
    got = native.inverse_sigmoid(y_sg, 2.0, 3.0)
    np.testing.assert_array_equal(got[:4], [-np.inf, -np.inf, np.inf, np.inf])
    np.testing.assert_allclose(got, jax_inverse_sigmoid(y_sg, 2.0, 3.0), rtol=REL_BOUND, atol=0)


@pytest.mark.parametrize("name", sorted(p.stem for p in FIXTURES.glob("*.frame")))
def test_codec_loops_equal_python_decoders_and_jax(name):
    # libblosc-written frames (lz4, lz4hc, blosclz, snappy, zlib; byte and
    # bit shuffle): the C++ loops, the port's pure-Python decoders and the
    # JAX package's decoder give the same bytes, the raw file's
    frame = (FIXTURES / f"{name}.frame").read_bytes()
    raw = (FIXTURES / f"{name}.raw").read_bytes()
    assert TB.blosc_decode(frame, decoder="native") == raw
    assert TB.blosc_decode(frame, decoder="python") == raw
    assert JB.blosc_decode(frame) == raw


@pytest.mark.parametrize("typesize, n", [(1, 100), (4, 4099), (8, 65536), (3, 1001)])
def test_lz4_and_unshuffle_native_equal_python(typesize, n):
    rng = np.random.default_rng(typesize)
    data = np.round(rng.normal(size=n // max(typesize, 1) + 1), 2).astype(np.float64).tobytes()[:n]
    shuffled = JB._shuffle(data, typesize)
    assert native.byte_unshuffle(shuffled, typesize) == TB._unshuffle_py(shuffled, typesize) == data
    comp = TB.lz4_compress(shuffled)
    assert comp == JB.lz4_compress(shuffled)
    assert native.lz4_decompress(comp, len(shuffled)) == TB._lz4_decompress_py(comp, len(shuffled)) == shuffled
    assert JB._lz4_decompress_py(comp, len(shuffled)) == shuffled
    with pytest.raises(ValueError, match="corrupt lz4"):
        native.lz4_decompress(comp[: len(comp) // 2], len(shuffled))
    with pytest.raises(ValueError, match="decoder"):
        TB.blosc_decode(TB.blosc_encode(data, typesize), decoder="numba")


def test_grid_index_handles_from_two_threads():
    # two indices over different points, queried from two threads at once,
    # many times: each thread gets its own index's answer every time
    a_pts, experts = binned(seed=4)
    b_pts, _ = binned(seed=5, keep=0.3)
    want = {}
    for tag, pts in (("a", a_pts), ("b", b_pts)):
        with native.GridIndex(pts, 200.0) as g:
            want[tag] = g.query(experts, 200.0)
    indices = {"a": native.GridIndex(a_pts, 200.0), "b": native.GridIndex(b_pts, 200.0)}
    errors = []
    barrier = threading.Barrier(2)

    def work(tag):
        try:
            barrier.wait()
            for _ in range(200):
                got = indices[tag].query(experts, 200.0)
                assert all(np.array_equal(g, w) for g, w in zip(got, want[tag])), tag
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g in indices.values():
        g.close()
    assert not errors, errors
    assert sum(map(len, want["a"])) != sum(map(len, want["b"]))
    with pytest.raises(ValueError, match="closed"):
        indices["a"].query(experts, 200.0)


def test_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    # a g++ failure raises from the build and from every entry point that
    # needs the library; the kdtree arm runs only when asked for
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "GXX_FLAGS", _build.GXX_FLAGS + ["-fno-such-flag"])
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _build.build_host_library(native.LIBRARY)
    pts, experts = binned(seed=6)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.radius_query_all(pts, experts, 150.0)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TSEL.local_select_indices_all({"x": pts[:, 0], "y": pts[:, 1]}, {"x": experts[:, 0], "y": experts[:, 1]},
                                      [{"col": ["x", "y"], "comp": "<", "val": 150.0}])
    assert not list((tmp_path / "build").glob("*.so")), "a failed build left a library behind"
    kd = native.radius_query_all(pts, experts, 150.0, index="kdtree")
    assert sum(map(len, kd)) > 0
    with pytest.raises(ValueError, match="index must be one of"):
        native.radius_query_all(pts, experts, 150.0, index="ball")


def test_library_name_hashes_source_flags_compiler_and_cpu(monkeypatch):
    path = _build.host_library_path(native.LIBRARY)
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libgpsat_native_")
    monkeypatch.setattr(_build, "GXX_FLAGS", _build.GXX_FLAGS + ["-g"])
    assert _build.host_library_path(native.LIBRARY) != path
    monkeypatch.setattr(_build, "GXX_FLAGS", [f for f in _build.GXX_FLAGS if f != "-g"])
    monkeypatch.setattr(_build, "_gxx_identity", lambda gxx: "another compiler")
    other_compiler = _build.host_library_path(native.LIBRARY)
    assert other_compiler != path
    monkeypatch.setattr(_build, "_cpu_identity", lambda: "another CPU")
    assert _build.host_library_path(native.LIBRARY) not in (path, other_compiler)


def test_host_source_names_no_jax():
    # the port's copy of the C++ speaks of PyTorch and CUDA, not of the JAX
    # package or XLA
    for src in sorted((REPO / "gpsat_tpu_torch" / "csrc" / "host").glob("*")):
        text = src.read_text()
        assert not re.search(r"\bjax\b|\bxla\b", text, re.IGNORECASE), src.name
        assert not re.search(r"gpsat_tpu(?!_torch)\b", text), src.name
