"""Solar zenith angle computation.

Provides ``cos_zenith_angle(time, lon_deg, lat_deg)`` — the dynamic input
feature the dataloaders compute per timestamp (the reference vendors climt's
implementation at ``makani/third_party/climt/zenith_angle.py:46-260``; this is
an independent implementation of the standard astronomical formulas).

Algorithm: low-precision solar ephemeris (Meeus). From the Julian centuries
since J2000 compute the sun's mean longitude/anomaly, the ecliptic longitude
via the equation of center, then declination and right ascension; the hour
angle follows from Greenwich mean sidereal time. Accuracy of the resulting
cos(zenith) is a few 1e-4 over +/- a century of J2000, ample for an input
feature.

Everything is plain numpy (it runs on the host inside the data pipeline).
"""

from __future__ import annotations

import datetime

import numpy as np

__all__ = ["cos_zenith_angle", "cos_zenith_angle_from_timestamp"]

_TWO_PI = 2.0 * np.pi
_J2000_EPOCH_TS = 946728000.0  # 2000-01-01 12:00:00 UTC as unix timestamp


def _to_timestamp(time) -> float:
    if isinstance(time, (int, float, np.integer, np.floating)):
        return float(time)
    if isinstance(time, datetime.datetime):
        if time.tzinfo is None:
            time = time.replace(tzinfo=datetime.timezone.utc)
        return time.timestamp()
    if isinstance(time, np.datetime64):
        return float(time.astype("datetime64[s]").astype(np.int64))
    raise TypeError(f"unsupported time type {type(time)}")


def _solar_position(t_centuries: np.ndarray):
    """Sun declination [rad] and equation-of-time correction via RA [rad]."""
    T = t_centuries
    # mean longitude and mean anomaly of the sun (deg)
    L0 = np.mod(280.46646 + 36000.76983 * T + 0.0003032 * T * T, 360.0)
    M = np.deg2rad(np.mod(357.52911 + 35999.05029 * T - 0.0001537 * T * T, 360.0))
    # equation of center
    C = (
        (1.914602 - 0.004817 * T - 0.000014 * T * T) * np.sin(M)
        + (0.019993 - 0.000101 * T) * np.sin(2 * M)
        + 0.000289 * np.sin(3 * M)
    )
    true_lon = np.deg2rad(L0 + C)
    # obliquity of the ecliptic
    eps = np.deg2rad(23.439291 - 0.0130042 * T)
    # declination and right ascension
    decl = np.arcsin(np.sin(eps) * np.sin(true_lon))
    ra = np.arctan2(np.cos(eps) * np.sin(true_lon), np.cos(true_lon))
    return decl, ra


def cos_zenith_angle_from_timestamp(timestamp: float, lon_deg: np.ndarray, lat_deg: np.ndarray) -> np.ndarray:
    """cos(solar zenith) on a lon/lat grid for a unix timestamp (UTC)."""
    days = (np.asarray(timestamp, dtype=np.float64) - _J2000_EPOCH_TS) / 86400.0
    T = days / 36525.0
    decl, ra = _solar_position(T)

    # Greenwich mean sidereal time (rad)
    gmst = np.deg2rad(np.mod(280.46061837 + 360.98564736629 * days, 360.0))

    lon = np.deg2rad(np.asarray(lon_deg, dtype=np.float64))
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float64))

    # local hour angle of the sun
    ha = gmst + lon - ra

    cz = np.sin(lat) * np.sin(decl) + np.cos(lat) * np.cos(decl) * np.cos(ha)
    return cz


def cos_zenith_angle(time, lon_deg, lat_deg) -> np.ndarray:
    """cos(solar zenith angle) for a datetime/timestamp over a lon/lat grid.

    ``lon_deg``/``lat_deg`` may be 1D axes or broadcastable 2D grids;
    1D inputs are meshed as (lat, lon).
    """
    lon = np.asarray(lon_deg, dtype=np.float64)
    lat = np.asarray(lat_deg, dtype=np.float64)
    if lon.ndim == 1 and lat.ndim == 1:
        lon, lat = np.meshgrid(lon, lat)
    ts = _to_timestamp(time)
    return cos_zenith_angle_from_timestamp(ts, lon, lat)
