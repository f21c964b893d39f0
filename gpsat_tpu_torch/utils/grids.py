"""Grid generation utilities (ref: GPSat/utils.py:1788-1885, :1075).

The port's own copy of ``gpsat_tpu/utils/grids.py``.

``grid_2d_flatten`` reproduces the reference's cell-center grid used for
expert locations and prediction grids; ``grid_nd_flatten`` generalizes it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _edges_1d(rng, grid_res=None, step_size=None, num_step=None):
    lo, hi = rng[0], rng[1]
    if grid_res is not None:
        n = int((hi - lo) / grid_res) + 1
        return np.linspace(lo, hi, n)
    if step_size is not None:
        return np.arange(lo, hi + step_size, step_size)
    if num_step is not None:
        return np.linspace(lo, hi, num_step)
    raise AssertionError("grid_res, step_size and num_step are all None, please provide one")


def grid_2d_flatten(
    x_range,
    y_range,
    grid_res: Optional[float] = None,
    step_size: Optional[float] = None,
    num_step: Optional[int] = None,
    center: bool = True,
) -> np.ndarray:
    """Flattened (x, y) grid; cell centers when ``center``.

    Row-major over y then x (x varies fastest), matching the reference
    (ref: GPSat/utils.py:1788-1885 — x is dim 1, y is dim 0).
    """
    x_edge = _edges_1d(x_range, grid_res, step_size, num_step)
    y_edge = _edges_1d(y_range, grid_res, step_size, num_step)
    if center:
        x = (x_edge[:-1] + x_edge[1:]) / 2.0
        y = (y_edge[:-1] + y_edge[1:]) / 2.0
    else:
        x, y = x_edge, y_edge
    X, Y = np.meshgrid(x, y)
    return np.concatenate([X.flatten()[:, None], Y.flatten()[:, None]], axis=1)


def grid_nd_flatten(ranges: Sequence, grid_res=None, step_size=None, num_step=None, center: bool = True) -> np.ndarray:
    """N-d generalization; last range varies fastest."""
    axes = []
    for rng in ranges:
        e = _edges_1d(rng, grid_res, step_size, num_step)
        axes.append((e[:-1] + e[1:]) / 2.0 if center else e)
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.flatten() for m in mesh], axis=1)
