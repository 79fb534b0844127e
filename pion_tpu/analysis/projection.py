"""Synthetic observations: line-of-sight projections of emissivities.

JAX equivalent of the reference projection tools
(reference: analysis/projection/project2D.cpp:87,286-342 — Halpha, [NII]
6584, emission measure and X-ray maps from 2D axisymmetric snapshots;
analysis/projection3D/ for 3D volumes; emissivity functions from
analysis/xray/xray_emission.cpp:263-295).

The axisymmetric projection is an Abel-type integral: for impact parameter
b, I(z,b) = sum over annuli R>=b of j(R,z) * chord(R,b).  The chord-length
weights form a static (n_b x n_R) matrix, so projecting a whole snapshot is
one matrix product per emissivity.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SimConfig
from ..constants import K_B, M_P, PG, RO

PARSEC = 3.0856775807e18


def _gas_quantities(P, cfg: SimConfig, mp=None):
    """(n_e, n_Hp, n_H, T) from a snapshot; uses the chemistry module when
    available, else assumes fully-ionized solar-ish gas."""
    if mp is not None:
        nH = mp.n_H(P[RO])
        x = P[mp.mpc.tracer_slot]
        ne = getattr(mp.mpc, "n_elec", 1.0) * x * nH
        n_hp = x * nH
        T = mp.temperature(P, cfg)
    else:
        nH = P[RO] / (M_P / 0.715)
        ne = 1.1 * nH
        n_hp = nH
        T = P[PG] / (2.2 * jnp.maximum(nH, 1.0e-30) * K_B)
    # floor T so vacuum/out-of-domain samples (rho=p=0 after an angled-LOS
    # rotation) give 0 * finite instead of 0 * inf in T-power emissivities
    return ne, n_hp, nH, jnp.maximum(T, 1.0)


def halpha_emissivity(ne, n_hp, T):
    """j(Ha) = 2.63e-33 n_e n_p T^-0.9 [erg/cm^3/s/arcsec^2]
    (reference: xray_emission.cpp:265-274, from Osterbrock)."""
    return 2.63e-33 * ne * n_hp * T ** (-0.9)


def nii6584_emissivity(ne, n_hp, T, frac_n=1.0):
    """[NII] 6584A emissivity (Dopita 1973 fit; reference:
    xray_emission.cpp:283-295), solar N abundance scaling via frac_n."""
    return (1.27563e-29 * frac_n * ne * n_hp
            * jnp.exp(-2.1855e4 / T - T * T / 1.0e10) / jnp.sqrt(T))


def emission_measure(ne, n_hp):
    """EM integrand n_e n_p [cm^-6]; projected EM usually quoted in
    cm^-6 pc (divide the integral by one parsec)."""
    return ne * n_hp


def brems6ghz_emissivity(ne, T):
    """Free-free radio continuum at 6 GHz, n_e^2 * 3.27e-23 (T/1e4K)^-0.35
    * nu_GHz^-0.1 [MJy/ster/cm] (reference: xray_emission.cpp:303-315
    Brems6GHz_emissivity; Condon & Ransom eq. 4.54/4.60)."""
    return 3.27e-23 * 6.0 ** (-0.1) * ne * ne * (T * 1.0e-4) ** (-0.35)


_MAXDENS = 25000.0  # LINMAX_DENSITY weighting cap (point_quantities.cpp:172)


def stokes_q(rho, b_img_x, b_img_y):
    """Linearly-polarized synchrotron Stokes Q integrand, density-weighted
    with the reference's LINMAX cap: min(n_H, 25000) (Bx^2-By^2)/|B_perp|
    (reference: projection3D/point_quantities.cpp:173-222 get_point_StokesQ).
    ``b_img_x/y`` are the plane-of-sky field components in image coords."""
    bx2 = b_img_x * b_img_x
    by2 = b_img_y * b_img_y
    bperp = jnp.sqrt(jnp.maximum(bx2 + by2, 1.0e-60))
    return jnp.minimum(rho / M_P, _MAXDENS) * (bx2 - by2) / bperp


def stokes_u(rho, b_img_x, b_img_y):
    """Stokes U integrand: min(n_H, 25000) * 2 Bx By / |B_perp|
    (reference: point_quantities.cpp:229-280 get_point_StokesU)."""
    bx2 = b_img_x * b_img_x
    by2 = b_img_y * b_img_y
    bperp = jnp.sqrt(jnp.maximum(bx2 + by2, 1.0e-60))
    return jnp.minimum(rho / M_P, _MAXDENS) * 2.0 * b_img_x * b_img_y / bperp


def b_component_abs(rho, b_comp, b_total2):
    """|B-component| map integrand: min(n_H, 25000) * B_i^2/|B|
    (reference: point_quantities.cpp:287-357 get_point_BXabs/BYabs)."""
    btot = jnp.sqrt(jnp.maximum(b_total2, 1.0e-60))
    return jnp.minimum(rho / M_P, _MAXDENS) * b_comp * b_comp / btot


def rotation_measure(ne, b_los):
    """Faraday rotation-measure integrand n_e * B_los; the projection
    multiplies by dl/parsec * 1e6 * sqrt(4pi) to give RM in rad/m^2 (the
    code's B unit is Gauss/sqrt(4pi); reference:
    point_quantities.cpp:367-401 get_point_RotationMeasure and the
    normalization at sim_projection.cpp:1211-1223)."""
    return ne * b_los


# X-ray band emissivity tables.  The reference interpolates log(L(>E)) vs
# log(T) tables for the eight bands >0.1/0.2/0.3/0.5/1/2/5/10 keV computed
# offline with XSPEC (reference: analysis/xray/xray_emission.h:28-74
# setup_xray_tables; its derived text table ships as xray-table.txt next to
# the projection tools).  Supply that file via XrayTables.from_file /
# set_xray_table for EXACT parity; without one, a built-in approximate
# model is used (free-free + CIE line bump), quantified against the XSPEC
# table in tests/test_analysis.py (typical 0.15 dex, <1 dex, 0.1-2 keV).
XRAY_BANDS_KEV = (0.1, 0.2, 0.3, 0.5, 1.0, 2.0, 5.0, 10.0)
_XR_LOGT = np.linspace(4.0, 9.0, 161)


class XrayTables:
    """log10 Lambda_X(>E) vs log10 T per band (reference:
    Xray_emission::setup_xray_tables_priv, xray_emission.cpp:60-160)."""

    def __init__(self, logt: np.ndarray, tabs: dict):
        self.logt = np.asarray(logt)
        self.tabs = {float(k): np.asarray(v) for k, v in tabs.items()}

    @classmethod
    def from_file(cls, path: str) -> "XrayTables":
        """Load the reference's XSPEC-derived text table format
        ('log10(T) T(K) E(keV) j(E>0.1) ... j(E>10)', 8 band columns —
        xray_emission.cpp:88-160): supplying the same xray-table.txt the
        reference uses reproduces its band emissivities exactly (log-log
        linear interpolation on the identical data)."""
        rows = []
        with open(path) as f:
            for line in f:
                if not line.strip() or "#" in line:
                    continue
                parts = [float(x) for x in line.split()]
                if len(parts) >= 11:
                    rows.append(parts)
        if not rows:
            raise ValueError(f"no rows in X-ray table {path}")
        a = np.asarray(rows)
        logt = a[:, 0]
        tabs = {e0: np.log10(np.maximum(a[:, 3 + i], 1e-99))
                for i, e0 in enumerate(XRAY_BANDS_KEV)}
        return cls(logt, tabs)

    @classmethod
    def builtin(cls) -> "XrayTables":
        """Approximate built-in model: free-free continuum with Gaunt
        factor plus a solar-abundance CIE line bump, partitioned into
        bands by the exponential photon-energy distribution.  Quantified
        against the reference's shipped XSPEC table in
        tests/test_analysis.py::test_xray_builtin_vs_reference_table
        (PARITY.md carries the band-by-band ratios)."""
        T = 10.0**_XR_LOGT
        kT_kev = T * K_B / 1.602176634e-9
        gaunt = 1.1 + 0.34 * np.exp(-((5.5 - np.log10(T)) ** 2) / 3.0)
        lam_ff = 1.426e-27 * np.sqrt(T) * gaunt
        lam_line = 6.0e-23 * np.exp(-((np.log10(T) - 6.3) ** 2) / 0.45)
        tabs = {}
        for e0 in XRAY_BANDS_KEV:
            frac = np.exp(-e0 / np.maximum(kT_kev, 1e-12))
            tabs[e0] = np.log10(np.maximum((lam_ff + lam_line) * frac,
                                           1e-60))
        return cls(_XR_LOGT, tabs)


_XRAY_DEFAULT = XrayTables.builtin()


def set_xray_table(path: str) -> None:
    """Replace the built-in approximate X-ray tables with a
    reference-format table file for exact parity (the reference ships
    xray-table.txt next to its projection tools)."""
    global _XRAY_DEFAULT
    _XRAY_DEFAULT = XrayTables.from_file(path)


def xray_emissivity(ne, nH, T, e_min_kev: float = 0.1, tables=None):
    """X-ray emissivity above e_min_kev: n_e n_H Lambda_X(T) [erg/cm^3/s].

    Table lookup in log T per band, log-linear interpolation between the
    two bracketing bands for off-menu thresholds (reference:
    analysis/xray/xray_emission.cpp:199-259 get_xray_emissivity over the
    same eight >E bands).  Matching the reference's out-of-range policy:
    zero emissivity below the table floor, linear log-log extrapolation
    above the ceiling (xray_emission.cpp:212-235)."""
    xt = tables if tables is not None else _XRAY_DEFAULT
    logT = jnp.log10(jnp.maximum(T, 1.0))
    bands = XRAY_BANDS_KEV
    lt = jnp.asarray(xt.logt)

    def interp(e0):
        tab = jnp.asarray(xt.tabs[e0])
        val = jnp.interp(logT, lt, tab)
        slope = (tab[-1] - tab[-2]) / (lt[-1] - lt[-2])
        val = jnp.where(logT > lt[-1], tab[-1] + slope * (logT - lt[-1]), val)
        return jnp.where(logT < lt[0], 0.0, 10.0**val)

    if float(e_min_kev) in xt.tabs:
        lam = interp(float(e_min_kev))
    else:
        i = int(np.clip(np.searchsorted(bands, e_min_kev) - 1, 0,
                        len(bands) - 2))
        w = (np.log(e_min_kev) - np.log(bands[i])) / (
            np.log(bands[i + 1]) - np.log(bands[i]))
        lam = interp(bands[i]) ** (1.0 - w) * interp(bands[i + 1]) ** w
    return lam * ne * nH


def abel_weights(R: np.ndarray, dR: float) -> np.ndarray:
    """Chord-length matrix W[b,R]: path length through the annulus
    [R-dR/2, R+dR/2] for a sight line at impact parameter b=R_b
    (reference: perp_projection.cpp geometry)."""
    nr = len(R)
    Rp = R + 0.5 * dR
    Rm = np.maximum(R - 0.5 * dR, 0.0)
    W = np.zeros((nr, nr))
    for ib in range(nr):
        b = R[ib]
        for ir in range(ib, nr):
            if Rp[ir] <= b:
                continue
            hi = np.sqrt(max(Rp[ir] ** 2 - b * b, 0.0))
            lo = np.sqrt(max(Rm[ir] ** 2 - b * b, 0.0))
            W[ib, ir] = 2.0 * (hi - lo)
    return W


def project_axisymmetric(P, cfg: SimConfig, mp=None,
                         quantities=("em", "halpha", "nii"),
                         e_min_kev: float = 0.1) -> Dict[str, jnp.ndarray]:
    """Project a 2D axisymmetric snapshot perpendicular to the symmetry
    axis.  Returns images of shape (n_b, n_z) keyed by quantity."""
    from ..constants import Coord

    assert cfg.ndim == 2 and cfg.coords is Coord.CYLINDRICAL
    ng = cfg.ng
    R = cfg.cell_centers(0)
    W = jnp.asarray(abel_weights(R, cfg.dx))
    ne, n_hp, nH, T = _gas_quantities(P, cfg, mp)
    out = {}
    for q in quantities:
        if q == "em":
            j = emission_measure(ne, n_hp) / PARSEC
        elif q == "halpha":
            j = halpha_emissivity(ne, n_hp, T)
        elif q == "nii":
            j = nii6584_emissivity(ne, n_hp, T)
        elif q == "xray":
            j = xray_emissivity(ne, nH, T, e_min_kev)
        elif q == "density":     # PROJ_D (projection_constants.h:5)
            j = P[RO]
        elif q == "neutral":     # PROJ_NtD
            j = jnp.maximum(nH - n_hp, 0.0)
        elif q == "ionized":     # PROJ_InD
            j = n_hp
        elif q == "brems6ghz":   # PROJ_BREMS6GHZ
            j = brems6ghz_emissivity(ne, T)
        else:
            raise ValueError(f"unknown projection quantity {q}")
        # (n_b, n_R) @ (n_R, n_z) -> (n_b, n_z); full f32 precision (a
        # float32 product may otherwise run in TF32)
        out[q] = jnp.matmul(W, j, precision=jax.lax.Precision.HIGHEST)
    return out


def project_3d(P, cfg: SimConfig, axis: int = 0, mp=None,
               quantities=("em", "halpha"),
               e_min_kev: float = 0.1) -> Dict[str, jnp.ndarray]:
    """Project a 3D snapshot along a grid axis (reference:
    analysis/projection3D/main_projection.cpp; quantity menu from
    analysis/projection/projection_constants.h:5-24 — density, neutral/
    ionized density, EM, X-ray bands, Halpha, [NII], Brems 6GHz, Stokes
    Q/U, |B_x|/|B_y|, rotation measure)."""
    from ..constants import BX as _BX

    assert cfg.ndim == 3
    ne, n_hp, nH, T = _gas_quantities(P, cfg, mp)
    rho = P[RO]
    if cfg.eqn.is_mhd:
        # physical axis of LOS: array axis a -> slot BX + (ndim-1-a)
        b_los = P[_BX + (cfg.ndim - 1 - axis)]
        img_axes = [a for a in range(3) if a != axis]
        b_img_y = P[_BX + (cfg.ndim - 1 - img_axes[0])]
        b_img_x = P[_BX + (cfg.ndim - 1 - img_axes[1])]
        b_tot2 = b_los**2 + b_img_x**2 + b_img_y**2
    out = {}
    for q in quantities:
        if q == "em":
            j = emission_measure(ne, n_hp) / PARSEC
        elif q == "halpha":
            j = halpha_emissivity(ne, n_hp, T)
        elif q == "nii":
            j = nii6584_emissivity(ne, n_hp, T)
        elif q == "xray":
            j = xray_emissivity(ne, nH, T, e_min_kev)
        elif q == "density":     # PROJ_D: surface mass density [g/cm^2]
            j = rho
        elif q == "neutral":     # PROJ_NtD: neutral H column [cm^-2]
            j = jnp.maximum(nH - n_hp, 0.0)
        elif q == "ionized":     # PROJ_InD: ionized H column [cm^-2]
            j = n_hp
        elif q == "brems6ghz":   # PROJ_BREMS6GHZ [MJy/ster]
            j = brems6ghz_emissivity(ne, T)
        elif q == "stokes_q":
            j = stokes_q(rho, b_img_x, b_img_y) / cfg.dx
        elif q == "stokes_u":
            j = stokes_u(rho, b_img_x, b_img_y) / cfg.dx
        elif q == "bxabs":
            j = b_component_abs(rho, b_img_x, b_tot2) / cfg.dx
        elif q == "byabs":
            j = b_component_abs(rho, b_img_y, b_tot2) / cfg.dx
        elif q == "rm":
            # reference normalization (sim_projection.cpp:1211-1223):
            # dl/parsec * 1e6 * sqrt(4pi) on the code's G/sqrt(4pi) B unit
            j = rotation_measure(ne, b_los) * (
                1.0e6 * np.sqrt(4.0 * np.pi) / PARSEC)
        else:
            raise ValueError(f"unknown projection quantity {q}")
        out[q] = jnp.sum(j, axis=axis) * cfg.dx
    return out


def _rotate_cube(P, cfg: SimConfig, axis: int, theta: float):
    """Resample the state so a line of sight tilted by ``theta`` lies along
    array ``axis``.

    JAX equivalent of projection3D's tilted-ray sampling
    (reference: analysis/projection3D/sim_projection.cpp builds rays at
    angle theta and bilinearly averages the 4 neighbouring cells per sample
    point — point_quantities.cpp `point_4cellavg` weights); here the whole
    cube is resampled once with trilinear ``map_coordinates`` (one fused
    gather, ideal for XLA) and vector components are rotated into the
    image frame.  Out-of-domain samples are zero (vacuum), matching rays
    leaving the box.
    """
    from jax.scipy.ndimage import map_coordinates

    assert cfg.ndim == 3
    # rotation plane: (LOS axis, the non-vertical image axis)
    perp = 2 if axis != 2 else 0
    ct = float(np.cos(theta))
    st = float(np.sin(theta))
    grids = jnp.meshgrid(*[jnp.arange(n, dtype=P.dtype)
                           for n in cfg.shape], indexing="ij")
    c_a = 0.5 * (cfg.shape[axis] - 1)
    c_p = 0.5 * (cfg.shape[perp] - 1)
    da = grids[axis] - c_a
    dp = grids[perp] - c_p
    coords = list(grids)
    coords[axis] = ct * da - st * dp + c_a
    coords[perp] = st * da + ct * dp + c_p

    def sample(plane):
        return map_coordinates(plane, coords, order=1, mode="constant",
                               cval=0.0)

    out = [sample(P[v]) for v in range(P.shape[0])]
    # rotate vector components (velocity and B) into the tilted frame:
    # physical axis of array axis a is k = ndim-1-a
    from ..constants import BX as _BX, VX as _VX

    ka, kp = cfg.ndim - 1 - axis, cfg.ndim - 1 - perp
    bases = [_VX] + ([_BX] if cfg.eqn.is_mhd else [])
    for base in bases:
        va, vp = out[base + ka], out[base + kp]
        out[base + ka] = ct * va + st * vp
        out[base + kp] = -st * va + ct * vp
    return jnp.stack(out)


def project_3d_los(P, cfg: SimConfig, axis: int = 0, theta: float = 0.0,
                   mp=None, quantities=("em", "halpha"),
                   e_min_kev: float = 0.1) -> Dict[str, jnp.ndarray]:
    """Project a 3D snapshot along a line of sight tilted by ``theta``
    radians from grid ``axis`` (reference: analysis/projection3D/
    main_projection.cpp — normal axis + angle in [-89, 89] degrees).

    ``theta=0`` reduces exactly to :func:`project_3d`."""
    if theta == 0.0:
        return project_3d(P, cfg, axis=axis, mp=mp, quantities=quantities,
                          e_min_kev=e_min_kev)
    Pr = _rotate_cube(P, cfg, axis, theta)
    return project_3d(Pr, cfg, axis=axis, mp=mp, quantities=quantities,
                      e_min_kev=e_min_kev)


def brems_freefree_emissivity(ne, T, nu_ghz=6.0):
    """Free-free radio continuum at ``nu_ghz``: n_e^2 * 3.27e-23
    (T/1e4K)^-0.35 nu^-0.1 [MJy/ster/cm] (reference:
    xray_emission.cpp:303-340 Brems6GHz/Brems20cm_emissivity)."""
    return 3.27e-23 * nu_ghz ** (-0.1) * ne * ne * (T * 1.0e-4) ** (-0.35)


def emissivity_cube(P, cfg: SimConfig, mp=None, xray_tables=None) -> Dict:
    """Per-cell emissivity cube (reference:
    analysis/emission-cubes/make_emission_cube.cpp:258-290): the snapshot's
    fields replaced by Halpha (x the 206265^2*4pi sky factor),
    20cm free-free (x 4pi), and the three X-ray band emissivities
    0.1-0.5 / 0.5-2 / 2-10 keV (n_e n_p (Lambda(>a)-Lambda(>b))), ready
    to write as a FITS/VTK cube."""
    ne, n_hp, _nH, T = _gas_quantities(P, cfg, mp)
    sky = 206265.0 ** 2 * 4.0 * np.pi

    def band(a, b):
        return (xray_emissivity(ne, n_hp, T, a, tables=xray_tables)
                - xray_emissivity(ne, n_hp, T, b, tables=xray_tables))

    return {
        "halpha": halpha_emissivity(ne, n_hp, T) * sky,
        "brems20cm": brems_freefree_emissivity(ne, T, nu_ghz=1.4)
        * 4.0 * np.pi,
        "xray_0.1-0.5keV": band(0.1, 0.5),
        "xray_0.5-2keV": band(0.5, 2.0),
        "xray_2-10keV": band(2.0, 10.0),
    }
