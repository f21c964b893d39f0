"""EASE2 <-> WGS84 coordinate projection, closed form.

The port's own copy of ``gpsat_tpu/utils/projections.py`` (numpy only).
The reference delegates to pyproj's Lambert azimuthal equal-area (laea)
projection on the WGS84 ellipsoid (ref: GPSat/utils.py:565-663, proj string
``+proj=laea +lon_0={lon_0} +lat_0={lat_0} +ellps=WGS84``). pyproj is not a
dependency here; this module implements the same projection from Snyder,
"Map Projections: A Working Manual" (USGS PP 1395), pp. 187-190, vectorized
over numpy arrays. ``utils/config_func`` registers the two projections
as ``@WGS84toEASE2`` and ``@EASE2toWGS84``.
"""

from __future__ import annotations

import numpy as np

# WGS84 ellipsoid
_A = 6378137.0
_F = 1.0 / 298.257223563
_E2 = _F * (2.0 - _F)
_E = np.sqrt(_E2)


def _q(sin_phi):
    """Snyder eq. 3-12: authalic-latitude auxiliary q."""
    esin = _E * sin_phi
    return (1.0 - _E2) * (
        sin_phi / (1.0 - _E2 * sin_phi**2) - (1.0 / (2.0 * _E)) * np.log((1.0 - esin) / (1.0 + esin))
    )


_QP = _q(1.0)  # q at the pole


def _authalic_to_geodetic(beta):
    """Snyder eq. 3-18: series converting authalic latitude to geodetic."""
    e2, e4, e6 = _E2, _E2**2, _E2**3
    return (
        beta
        + (e2 / 3.0 + 31.0 * e4 / 180.0 + 517.0 * e6 / 5040.0) * np.sin(2.0 * beta)
        + (23.0 * e4 / 360.0 + 251.0 * e6 / 3780.0) * np.sin(4.0 * beta)
        + (761.0 * e6 / 45360.0) * np.sin(6.0 * beta)
    )


def WGS84toEASE2(lon, lat, return_vals: str = "both", lon_0: float = 0, lat_0: float = 90):
    """Forward laea projection (degrees -> meters).

    Matches the reference's pyproj-based WGS84toEASE2
    (ref: GPSat/utils.py:565-619), e.g.
    WGS84toEASE2(-105.01621, 39.57422) == (-5254767.015, 1409604.104).
    """
    valid = ["both", "x", "y"]
    assert return_vals in valid, f"return_vals: {return_vals} not in {valid}"
    lon = np.asarray(lon, dtype=float)
    lat = np.asarray(lat, dtype=float)
    lam = np.deg2rad(lon - lon_0)
    phi = np.deg2rad(lat)
    q = _q(np.sin(phi))

    if lat_0 == 90:
        rho = _A * np.sqrt(np.maximum(_QP - q, 0.0))
        x = rho * np.sin(lam)
        y = -rho * np.cos(lam)
    elif lat_0 == -90:
        rho = _A * np.sqrt(np.maximum(_QP + q, 0.0))
        x = rho * np.sin(lam)
        y = rho * np.cos(lam)
    else:
        # oblique aspect (Snyder eqs. 24-19..24-21)
        phi1 = np.deg2rad(lat_0)
        q1 = _q(np.sin(phi1))
        beta1 = np.arcsin(q1 / _QP)
        beta = np.arcsin(np.clip(q / _QP, -1.0, 1.0))
        m1 = np.cos(phi1) / np.sqrt(1.0 - _E2 * np.sin(phi1) ** 2)
        Rq = _A * np.sqrt(_QP / 2.0)
        D = _A * m1 / (Rq * np.cos(beta1))
        B = Rq * np.sqrt(
            2.0 / (1.0 + np.sin(beta1) * np.sin(beta) + np.cos(beta1) * np.cos(beta) * np.cos(lam))
        )
        x = B * D * np.cos(beta) * np.sin(lam)
        y = (B / D) * (np.cos(beta1) * np.sin(beta) - np.sin(beta1) * np.cos(beta) * np.cos(lam))

    if return_vals == "both":
        return x, y
    return x if return_vals == "x" else y


def EASE2toWGS84(x, y, return_vals: str = "both", lon_0: float = 0, lat_0: float = 90):
    """Inverse laea projection (meters -> degrees).

    Matches the reference's pyproj-based EASE2toWGS84
    (ref: GPSat/utils.py:622-663), e.g.
    EASE2toWGS84(1000000, 2000000) == (153.4349488, 69.8689454).
    """
    valid = ["both", "lon", "lat"]
    assert return_vals in valid, f"return_vals: {return_vals} not in {valid}"
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)

    if lat_0 == 90:
        rho = np.sqrt(x**2 + y**2)
        q = _QP - (rho / _A) ** 2
        beta = np.arcsin(np.clip(q / _QP, -1.0, 1.0))
        phi = _authalic_to_geodetic(beta)
        lam = np.arctan2(x, -y)
        # at the pole itself longitude is arbitrary; pin to lon_0
        lam = np.where(rho == 0.0, 0.0, lam)
    elif lat_0 == -90:
        rho = np.sqrt(x**2 + y**2)
        q = -( _QP - (rho / _A) ** 2)
        beta = np.arcsin(np.clip(q / _QP, -1.0, 1.0))
        phi = _authalic_to_geodetic(beta)
        lam = np.arctan2(x, y)
        lam = np.where(rho == 0.0, 0.0, lam)
    else:
        phi1 = np.deg2rad(lat_0)
        q1 = _q(np.sin(phi1))
        beta1 = np.arcsin(q1 / _QP)
        m1 = np.cos(phi1) / np.sqrt(1.0 - _E2 * np.sin(phi1) ** 2)
        Rq = _A * np.sqrt(_QP / 2.0)
        D = _A * m1 / (Rq * np.cos(beta1))
        rho = np.sqrt((x / D) ** 2 + (D * y) ** 2)
        ce = 2.0 * np.arcsin(np.clip(rho / (2.0 * Rq), -1.0, 1.0))
        with np.errstate(invalid="ignore", divide="ignore"):
            q = _QP * (
                np.cos(ce) * np.sin(beta1) + D * y * np.sin(ce) * np.cos(beta1) / rho
            )
            lam = np.arctan2(
                x * np.sin(ce),
                D * rho * np.cos(beta1) * np.cos(ce) - D**2 * y * np.sin(beta1) * np.sin(ce),
            )
        q = np.where(rho == 0.0, _QP * np.sin(beta1), q)
        lam = np.where(rho == 0.0, 0.0, lam)
        beta = np.arcsin(np.clip(q / _QP, -1.0, 1.0))
        phi = _authalic_to_geodetic(beta)

    lon = np.rad2deg(lam) + lon_0
    lat = np.rad2deg(phi)
    if return_vals == "both":
        return lon, lat
    return lon if return_vals == "lon" else lat


def WGS84toEASE2_New(*args, **kwargs):
    """Deprecated alias kept for reference-API parity (ref: utils.py:556)."""
    return WGS84toEASE2(*args, **kwargs)


def EASE2toWGS84_New(*args, **kwargs):
    """Deprecated alias kept for reference-API parity (ref: utils.py:561)."""
    return EASE2toWGS84(*args, **kwargs)
