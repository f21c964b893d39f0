"""Synthetic observations from a ground-truth field
(ref: examples/Archive/sample_from_ground_truth.py; README.md:131-137).

Samples noisy observations at (real or synthetic) track locations from a
gridded ground-truth field — used for controlled-accuracy experiments
where the answer is known. The port's own copy of ``gpsat_tpu/synthetic.py``:
host-only, every draw from ``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd


def interp_2d(grid_vals: np.ndarray, x_grid: np.ndarray, y_grid: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Bilinear interpolation of grid_vals[y, x] at scattered (x, y)."""
    xi = np.interp(x, x_grid, np.arange(len(x_grid)))
    yi = np.interp(y, y_grid, np.arange(len(y_grid)))
    x0 = np.clip(np.floor(xi).astype(int), 0, len(x_grid) - 2)
    y0 = np.clip(np.floor(yi).astype(int), 0, len(y_grid) - 2)
    fx = np.clip(xi - x0, 0.0, 1.0)
    fy = np.clip(yi - y0, 0.0, 1.0)
    v00 = grid_vals[y0, x0]
    v01 = grid_vals[y0, x0 + 1]
    v10 = grid_vals[y0 + 1, x0]
    v11 = grid_vals[y0 + 1, x0 + 1]
    return (1 - fy) * ((1 - fx) * v00 + fx * v01) + fy * ((1 - fx) * v10 + fx * v11)


def sample_from_ground_truth(
    locations: pd.DataFrame,
    ground_truth: np.ndarray,
    x_grid: np.ndarray,
    y_grid: np.ndarray,
    noise_std: float = 0.0,
    x_col: str = "x",
    y_col: str = "y",
    obs_col: str = "obs",
    seed: Optional[int] = None,
    keep_cols: Optional[list] = None,
) -> pd.DataFrame:
    """Noisy samples of a gridded field at the given track locations."""
    rng = np.random.default_rng(seed)
    vals = interp_2d(ground_truth, x_grid, y_grid, locations[x_col].values, locations[y_col].values)
    if noise_std:
        vals = vals + noise_std * rng.normal(size=len(vals))
    out = locations[[x_col, y_col] + list(keep_cols or [])].copy()
    out[obs_col] = vals
    return out


def make_ground_truth_field(extent: float = 500_000.0, n: int = 181, seed: int = 0):
    """A smooth synthetic 'mean sea surface'-like field on an EASE2-like
    grid; returns (field [n, n], x_grid, y_grid)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-extent, extent, n)
    y = np.linspace(-extent, extent, n)
    X, Y = np.meshgrid(x, y)
    field = np.zeros_like(X)
    # frequency content scales with the domain so any extent gives ~1
    # oscillation per component across the field (identical to the old
    # fixed 1/150km scale at the default 500km extent)
    k_scale = (500_000.0 / 150_000.0) / extent
    for _ in range(6):
        kx, ky = rng.normal(scale=k_scale, size=2)
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.05, 0.3)
        field += amp * np.sin(kx * X + ky * Y + phase)
    return field, x, y


def make_tracks(extent: float = 500_000.0, n_tracks: int = 40, pts_per_track: int = 600, seed: int = 0) -> pd.DataFrame:
    """Straight pseudo-satellite tracks through a square domain."""
    rng = np.random.default_rng(seed)
    rows = []
    for t in range(n_tracks):
        theta = rng.uniform(0, np.pi)
        offset = rng.uniform(-extent, extent)
        s = np.linspace(-1.5 * extent, 1.5 * extent, pts_per_track)
        x = s * np.cos(theta) - offset * np.sin(theta)
        y = s * np.sin(theta) + offset * np.cos(theta)
        keep = (np.abs(x) < extent) & (np.abs(y) < extent)
        rows.append(pd.DataFrame({"x": x[keep], "y": y[keep], "track": t}))
    return pd.concat(rows, ignore_index=True)
