"""World coordinates without astropy (a copy of the JAX package's
``utils/wcs.py``).

:class:`SimpleWCS` holds the standard FITS WCS keywords (CRVAL, CRPIX,
CDELT, PC, CD, CTYPE, CUNIT, RADESYS, ...), round-trips them through every
I/O format, and implements the celestial TAN (gnomonic) projection of FITS
WCS Paper II (Calabretta & Greisen 2002), so sky coordinates work without
astropy. The header cards are plain FITS WCS keywords: astropy builds an
equivalent ``astropy.wcs.WCS`` from any file this package writes.
Anywhere a WCS is accepted, an ``astropy.wcs.WCS`` also works (its
``to_header()`` is used for serialisation).
"""

import numpy as np

__all__ = ["SimpleWCS", "wcs_to_header", "wcs_from_header"]

# FITS WCS keywords persisted for 2-d celestial headers
WCS_KEYS_FLOAT = (
    "CRVAL1", "CRVAL2", "CRPIX1", "CRPIX2", "CDELT1", "CDELT2",
    "PC1_1", "PC1_2", "PC2_1", "PC2_2",
    "CD1_1", "CD1_2", "CD2_1", "CD2_2",
    "LONPOLE", "LATPOLE", "EQUINOX", "MJD-OBS",
)
WCS_KEYS_STR = ("CTYPE1", "CTYPE2", "CUNIT1", "CUNIT2", "RADESYS")
WCS_KEYS_INT = ("WCSAXES",)


class SimpleWCS:
    """2-d celestial FITS WCS: keyword container + TAN projection.

    Parameters
    ----------
    header : dict
        FITS WCS keywords. Unknown keys are ignored; recognised keys
        are the standard celestial set (see ``WCS_KEYS_*``).
    """

    def __init__(self, header):
        self._cards = {}
        for key in WCS_KEYS_FLOAT:
            if key in header and header[key] is not None:
                self._cards[key] = float(header[key])
        for key in WCS_KEYS_STR:
            if key in header and header[key] is not None:
                self._cards[key] = str(header[key]).strip()
        for key in WCS_KEYS_INT:
            if key in header and header[key] is not None:
                self._cards[key] = int(header[key])

    # ------------------------------------------------------------------
    @classmethod
    def from_header(cls, header):
        """Build from a FITS header (dict-like); None if no WCS."""
        if "CTYPE1" not in header:
            return None
        return cls(dict(header))

    def to_header(self):
        """FITS WCS keyword cards (plain dict)."""
        cards = dict(self._cards)
        cards.setdefault("WCSAXES", 2)
        return cards

    # reference API parity: astropy's WCS also exposes to_header()
    def to_dict(self):
        return self.to_header()

    @classmethod
    def from_dict(cls, data):
        return cls(data)

    def __eq__(self, other):
        if not isinstance(other, SimpleWCS):
            return NotImplemented
        return self.to_header() == other.to_header()

    def __repr__(self):
        ctype = self._cards.get("CTYPE1", "?"), self._cards.get("CTYPE2", "?")
        crval = self._cards.get("CRVAL1"), self._cards.get("CRVAL2")
        return f"SimpleWCS(ctype={ctype}, crval={crval})"

    # ------------------------------------------------------------------
    @property
    def _cd(self):
        """Linear transformation matrix (deg/pixel)."""
        c = self._cards
        if "CD1_1" in c:
            return np.array(
                [[c.get("CD1_1", 0.0), c.get("CD1_2", 0.0)],
                 [c.get("CD2_1", 0.0), c.get("CD2_2", 0.0)]]
            )
        pc = np.array(
            [[c.get("PC1_1", 1.0), c.get("PC1_2", 0.0)],
             [c.get("PC2_1", 0.0), c.get("PC2_2", 1.0)]]
        )
        cdelt = np.array([c.get("CDELT1", 1.0), c.get("CDELT2", 1.0)])
        return cdelt[:, None] * pc

    @property
    def _is_tan(self):
        return self._cards.get("CTYPE1", "").endswith("TAN")

    def pixel_to_world(self, x, y):
        """0-based pixel -> (lon, lat) in degrees (TAN projection)."""
        if not self._is_tan:
            raise NotImplementedError(
                f"Only the TAN projection is implemented, got "
                f"CTYPE1={self._cards.get('CTYPE1')!r}"
            )
        c = self._cards
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        # intermediate world coordinates (deg); FITS CRPIX is 1-based
        dp = np.stack(
            [x + 1.0 - c["CRPIX1"], y + 1.0 - c["CRPIX2"]], axis=0
        )
        u, v = np.tensordot(self._cd, dp, axes=1)

        # native spherical coordinates of the TAN projection
        r = np.hypot(u, v)
        phi = np.arctan2(u, -v)
        theta = np.arctan2(180.0 / np.pi, r)

        # native -> celestial: fiducial point is the native pole
        d2r = np.pi / 180.0
        alpha_p = c["CRVAL1"] * d2r
        delta_p = c["CRVAL2"] * d2r
        phi_p = c.get("LONPOLE", 180.0) * d2r

        sin_t, cos_t = np.sin(theta), np.cos(theta)
        sin_dp, cos_dp = np.sin(delta_p), np.cos(delta_p)
        dphi = phi - phi_p
        delta = np.arcsin(
            np.clip(sin_t * sin_dp + cos_t * cos_dp * np.cos(dphi), -1, 1)
        )
        alpha = alpha_p + np.arctan2(
            -cos_t * np.sin(dphi),
            sin_t * cos_dp - cos_t * sin_dp * np.cos(dphi),
        )
        return (np.degrees(alpha) % 360.0), np.degrees(delta)

    def world_to_pixel(self, lon, lat):
        """(lon, lat) degrees -> 0-based pixel (TAN projection)."""
        if not self._is_tan:
            raise NotImplementedError(
                f"Only the TAN projection is implemented, got "
                f"CTYPE1={self._cards.get('CTYPE1')!r}"
            )
        c = self._cards
        d2r = np.pi / 180.0
        alpha = np.asarray(lon, np.float64) * d2r
        delta = np.asarray(lat, np.float64) * d2r
        alpha_p = c["CRVAL1"] * d2r
        delta_p = c["CRVAL2"] * d2r
        phi_p = c.get("LONPOLE", 180.0) * d2r

        da = alpha - alpha_p
        sin_d, cos_d = np.sin(delta), np.cos(delta)
        sin_dp, cos_dp = np.sin(delta_p), np.cos(delta_p)
        theta = np.arcsin(
            np.clip(sin_d * sin_dp + cos_d * cos_dp * np.cos(da), -1, 1)
        )
        phi = phi_p + np.arctan2(
            -cos_d * np.sin(da),
            sin_d * cos_dp - cos_d * sin_dp * np.cos(da),
        )

        r = (180.0 / np.pi) / np.tan(theta)
        u = r * np.sin(phi)
        v = -r * np.cos(phi)
        dp = np.linalg.solve(self._cd, np.stack([u, v], axis=0))
        return dp[0] + c["CRPIX1"] - 1.0, dp[1] + c["CRPIX2"] - 1.0

    # astropy SkyCoord-compatible entry point used by
    # SparseSpatialFluxComponent.from_sky_coord
    def to_pixel(self, lon, lat):
        return self.world_to_pixel(lon, lat)


def wcs_to_header(wcs):
    """Serialise any supported WCS to a plain dict of FITS cards.

    Accepts :class:`SimpleWCS`, an ``astropy.wcs.WCS`` (duck-typed via
    ``to_header()``), or an already-plain dict of cards.
    """
    if wcs is None:
        return None
    if isinstance(wcs, SimpleWCS):
        return wcs.to_header()
    if isinstance(wcs, dict):
        return dict(wcs)
    if hasattr(wcs, "to_header"):
        header = wcs.to_header()
        return {str(k): v for k, v in header.items()}
    raise TypeError(f"Cannot serialise WCS of type {type(wcs)!r}")


def wcs_from_header(header):
    """Reconstruct a :class:`SimpleWCS` from FITS cards (or None)."""
    if header is None:
        return None
    return SimpleWCS.from_header(header)
