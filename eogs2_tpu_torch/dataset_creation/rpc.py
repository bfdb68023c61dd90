"""RPC camera model + UTM conversion (self-contained).

Counterpart of ``eogs2_tpu/dataset_creation/rpc.py`` (a copy: numpy in
float64 on the host, as dataset creation is offline).

Replaces the reference's external rpcm/utm dependencies
(scripts/dataset_creation/converter.py:3-4) with direct implementations:

  * RPCModel: RPC00B rational cubic polynomials in the rpcm dict format
    (row/col offsets+scales, 20-coefficient num/den), with projection
    (ground -> image) and iterative localization (image -> ground, Newton
    with finite-difference Jacobian — rpcm's localization_iterative).
  * latlon -> UTM via the standard Krüger series (sub-mm agreement with the
    `utm` package over satellite-scene extents).
"""

from __future__ import annotations

import numpy as np


def _apply_poly(poly, x, y, z):
    """RPC00B 20-term cubic (rpcm.apply_poly argument convention)."""
    out = poly[0]
    out = out + poly[1] * y + poly[2] * x + poly[3] * z
    out = out + poly[4] * y * x + poly[5] * y * z + poly[6] * x * z
    out = out + poly[7] * y * y + poly[8] * x * x + poly[9] * z * z
    out = out + poly[10] * x * y * z
    out = out + poly[11] * y * y * y
    out = out + poly[12] * y * x * x + poly[13] * y * z * z + poly[14] * y * y * x
    out = out + poly[15] * x * x * x
    out = out + poly[16] * x * z * z + poly[17] * y * y * z + poly[18] * x * x * z
    out = out + poly[19] * z * z * z
    return out


class RPCModel:
    """Rational polynomial camera (rpcm dict format)."""

    def __init__(self, d: dict, dict_format: str = "rpcm"):
        assert dict_format == "rpcm"
        self.row_offset = float(d["row_offset"])
        self.col_offset = float(d["col_offset"])
        self.lat_offset = float(d["lat_offset"])
        self.lon_offset = float(d["lon_offset"])
        self.alt_offset = float(d["alt_offset"])
        self.row_scale = float(d["row_scale"])
        self.col_scale = float(d["col_scale"])
        self.lat_scale = float(d["lat_scale"])
        self.lon_scale = float(d["lon_scale"])
        self.alt_scale = float(d["alt_scale"])
        self.row_num = np.asarray(d["row_num"], np.float64)
        self.row_den = np.asarray(d["row_den"], np.float64)
        self.col_num = np.asarray(d["col_num"], np.float64)
        self.col_den = np.asarray(d["col_den"], np.float64)

    def projection(self, lon, lat, alt):
        """(lon, lat, alt) -> (col, row) in pixels."""
        nlon = (np.asarray(lon) - self.lon_offset) / self.lon_scale
        nlat = (np.asarray(lat) - self.lat_offset) / self.lat_scale
        nalt = (np.asarray(alt) - self.alt_offset) / self.alt_scale
        col = _apply_poly(self.col_num, nlat, nlon, nalt) / _apply_poly(
            self.col_den, nlat, nlon, nalt
        )
        row = _apply_poly(self.row_num, nlat, nlon, nalt) / _apply_poly(
            self.row_den, nlat, nlon, nalt
        )
        return col * self.col_scale + self.col_offset, row * self.row_scale + self.row_offset

    def localization(self, col, row, alt, n_iter: int = 100, tol: float = 1e-10):
        """(col, row, alt) -> (lon, lat): Newton inversion at fixed altitude."""
        col = np.atleast_1d(np.asarray(col, np.float64))
        row = np.atleast_1d(np.asarray(row, np.float64))
        alt = np.broadcast_to(np.asarray(alt, np.float64), col.shape).copy()
        lon = np.full_like(col, self.lon_offset)
        lat = np.full_like(col, self.lat_offset)
        eps_lon = self.lon_scale * 1e-6
        eps_lat = self.lat_scale * 1e-6
        for _ in range(n_iter):
            c0, r0 = self.projection(lon, lat, alt)
            fx = c0 - col
            fy = r0 - row
            if max(np.abs(fx).max(), np.abs(fy).max()) < tol:
                break
            c1, r1 = self.projection(lon + eps_lon, lat, alt)
            c2, r2 = self.projection(lon, lat + eps_lat, alt)
            j11 = (c1 - c0) / eps_lon  # dcol/dlon
            j12 = (c2 - c0) / eps_lat  # dcol/dlat
            j21 = (r1 - r0) / eps_lon
            j22 = (r2 - r0) / eps_lat
            det = j11 * j22 - j12 * j21
            det = np.where(np.abs(det) < 1e-18, 1e-18, det)
            dlon = (j22 * fx - j12 * fy) / det
            dlat = (-j21 * fx + j11 * fy) / det
            lon = lon - dlon
            lat = lat - dlat
        squeeze = lon.shape == (1,)
        if squeeze:
            return float(lon[0]), float(lat[0])
        return lon, lat


# ---- UTM (WGS84, Krüger series — `utm` package parity) ---------------------

_K0 = 0.9996
_E = 0.00669438
_E2 = _E * _E
_E3 = _E2 * _E
_E_P2 = _E / (1.0 - _E)
_SQRT_E = np.sqrt(1.0 - _E)
_BETA = (1.0 - _SQRT_E) / (1.0 + _SQRT_E)
_BETA2 = _BETA * _BETA
_BETA3 = _BETA2 * _BETA
_BETA4 = _BETA3 * _BETA
_BETA5 = _BETA4 * _BETA
_P2 = 3.0 / 2 * _BETA - 27.0 / 32 * _BETA3 + 269.0 / 512 * _BETA5
_P3 = 21.0 / 16 * _BETA2 - 55.0 / 32 * _BETA4
_P4 = 151.0 / 96 * _BETA3 - 417.0 / 128 * _BETA5
_P5 = 1097.0 / 512 * _BETA4
_R = 6378137
_M1 = 1 - _E / 4 - 3 * _E2 / 64 - 5 * _E3 / 256
_M2 = 3 * _E / 8 + 3 * _E2 / 32 + 45 * _E3 / 1024
_M3 = 15 * _E2 / 256 + 45 * _E3 / 1024
_M4 = 35 * _E3 / 3072
_ZONE_LETTERS = "CDEFGHJKLMNPQRSTUVWXX"


def latlon_to_zone_number(lat, lon):
    if 56 <= lat < 64 and 3 <= lon < 12:
        return 32
    if 72 <= lat <= 84 and lon >= 0:
        if lon < 9:
            return 31
        if lon < 21:
            return 33
        if lon < 33:
            return 35
        if lon < 42:
            return 37
    return int((lon + 180) / 6) + 1


def latitude_to_zone_letter(lat):
    if -80 <= lat <= 84:
        return _ZONE_LETTERS[int(lat + 80) >> 3]
    return None


def from_latlon(lat, lon, force_zone_number=None):
    """(lat, lon) degrees -> (easting, northing, zone_number, zone_letter).

    `utm.from_latlon` parity; accepts arrays (zone taken from the first
    element like the reference's scene-wide usage)."""
    lat = np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    lat0 = float(np.ravel(lat)[0])
    lon0 = float(np.ravel(lon)[0])
    zone_number = force_zone_number or latlon_to_zone_number(lat0, lon0)
    zone_letter = latitude_to_zone_letter(lat0)

    lat_rad = np.radians(lat)
    lat_sin = np.sin(lat_rad)
    lat_cos = np.cos(lat_rad)
    lat_tan = lat_sin / lat_cos
    lat_tan2 = lat_tan * lat_tan
    lat_tan4 = lat_tan2 * lat_tan2
    lon_rad = np.radians(lon)
    central_lon = (zone_number - 1) * 6 - 180 + 3
    central_lon_rad = np.radians(central_lon)

    n = _R / np.sqrt(1 - _E * lat_sin**2)
    c = _E_P2 * lat_cos**2
    a = lat_cos * ((lon_rad - central_lon_rad + np.pi) % (2 * np.pi) - np.pi)
    a2 = a * a
    a3 = a2 * a
    a4 = a3 * a
    a5 = a4 * a
    a6 = a5 * a
    m = _R * (
        _M1 * lat_rad
        - _M2 * np.sin(2 * lat_rad)
        + _M3 * np.sin(4 * lat_rad)
        - _M4 * np.sin(6 * lat_rad)
    )
    easting = (
        _K0
        * n
        * (
            a
            + a3 / 6 * (1 - lat_tan2 + c)
            + a5 / 120 * (5 - 18 * lat_tan2 + lat_tan4 + 72 * c - 58 * _E_P2)
        )
        + 500000
    )
    northing = _K0 * (
        m
        + n
        * lat_tan
        * (
            a2 / 2
            + a4 / 24 * (5 - lat_tan2 + 9 * c + 4 * c**2)
            + a6 / 720 * (61 - 58 * lat_tan2 + lat_tan4 + 600 * c - 330 * _E_P2)
        )
    )
    northing = np.where(lat < 0, northing + 10000000, northing)
    if np.ndim(lat) == 0:
        return float(easting), float(northing), zone_number, zone_letter
    return easting, northing, zone_number, zone_letter
