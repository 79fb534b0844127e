"""StarBench workshop test initial conditions.

JAX re-derivation of the StarBench IC generators
(reference: source/ics/StarBench_test.cpp:63-959, dispatched from
icgen_base.cpp:99-116).  All generators fill dense primitive arrays
``(nvar, *spatial)`` vectorized over the grid; spatial axes are in array
order (slow...fast) with PION's x-axis last (see config.SimConfig).

The tests (Bisbas et al. 2015, MNRAS 453, 1324 and workshop documents):

- ContactDiscontinuity1-4: advected contact discontinuity with density
  ratios 10/1000, 1D and 2D-rotated-square variants.
- IFI_testA/B/C: D-type ionization-front instability, uniform neutral
  medium (test C adds an upstream shear perturbation).
- IFI_V2 (planar_if): pre-built planar D-type front with shell, with a
  menu of seed perturbations.
- IrrCloud_Uniform / IrrCloud_IsoSph: irradiated cloud (TLUSTY flux).
- TremblinCooling: shadowing/mixing/cooling test, uniform ionized gas.
- Cone: photoevaporating cone with 1/r^2 envelope (Iliev test-6-like).
"""
from __future__ import annotations

import numpy as np

from ..config import SimConfig
from ..constants import K_B, M_P, PARSEC, PG, RO, VX, VY, VZ

__all__ = [
    "contact_discontinuity",
    "ifi_test",
    "planar_if",
    "irradiated_cloud",
    "tremblin_cooling",
    "cone",
]


def _blank(cfg: SimConfig) -> np.ndarray:
    return np.zeros((cfg.nvar,) + cfg.shape)


def _mesh(cfg: SimConfig):
    coords = [cfg.cell_centers(ax) for ax in range(cfg.ndim)]
    return np.meshgrid(*coords, indexing="ij")


def _set_tracers(P, cfg: SimConfig, value):
    for tr in range(cfg.eqn.nbase, cfg.nvar):
        P[tr] = value
    return P


def contact_discontinuity(cfg: SimConfig, test_id: int = 1,
                          vx: float = 1.0, vy: float = 0.0) -> np.ndarray:
    """StarBench_ContactDiscontinuity1-4 (StarBench_test.cpp:156-313).

    Tests 1/2 are 1D: density 1 -> {10, 1000} at x=0.5, uniform pressure
    {10, 1000}, advection velocity (vx).  Tests 3/4 are 2D: a square of
    side 0.5, rotated by theta=1 rad about its centre (1, 1), density
    {10, 1000} inside vs 1 outside, advected with (vx, vy).  One colour
    tracer marks the dense phase.
    """
    if test_id not in (1, 2, 3, 4):
        raise ValueError(f"ContactDiscontinuity test_id must be 1-4: {test_id}")
    P = _blank(cfg)
    if test_id <= 2:
        assert cfg.ndim == 1, "ContactDiscontinuity1/2 is a 1D test"
        (x,) = _mesh(cfg)
        rho_hi = 10.0 if test_id == 1 else 1000.0
        dense = x >= 0.5
        P[RO] = np.where(dense, rho_hi, 1.0)
        P[PG] = rho_hi  # pg == dense-side density in both tests
        P[VX] = vx
        _set_tracers(P, cfg, dense.astype(float))
    else:
        assert cfg.ndim == 2, "ContactDiscontinuity3/4 is a 2D test"
        Y, X = _mesh(cfg)
        rho_hi = 10.0 if test_id == 3 else 1000.0
        # Rotated square: the four bounding lines of a square rotated by
        # theta=1 rad about (1, 1), half-diagonal set by 1/(4 sin theta).
        theta = 1.0
        tt = np.tan(theta)
        itt = 1.0 / tt
        ifst = 1.0 / (4.0 * np.sin(theta))
        inside = (
            (Y <= 1.0 + itt + ifst - X * itt)
            & (Y >= 1.0 + itt - ifst - X * itt)
            & (Y <= tt * (X - (1.0 - itt - ifst)))
            & (Y >= tt * (X - (1.0 - itt + ifst)))
        )
        P[RO] = np.where(inside, rho_hi, 1.0)
        P[PG] = rho_hi
        P[VX] = vx
        P[VY] = vy
        _set_tracers(P, cfg, inside.astype(float))
    return P


def ifi_test(cfg: SimConfig, test: str = "A") -> np.ndarray:
    """StarBench_IFI_testA/B/C (StarBench_test.cpp:731-771).

    Uniform neutral pure-H medium, n(H)=44 cm^-3 at 10 K; the ionizing
    source at the x-boundary drives the D-type front.  Test C seeds a
    shear-velocity perturbation: vy = 0.75 c_i sin(2 pi y/lambda)
    * gaussian(x; x0=xmin+0.12 Lx, sigma=0.05 Lx), lambda = Ly/8.
    """
    test = test.upper()
    if test not in ("A", "B", "C"):
        raise ValueError(f"IFI test must be A, B or C: {test}")
    P = _blank(cfg)
    P[RO] = 44.0 * M_P
    P[PG] = 44.0 * K_B * 10.0
    _set_tracers(P, cfg, 0.0)
    if test == "C":
        assert cfg.ndim == 2
        Y, X = _mesh(cfg)
        ylo, yhi = cfg.xmin[0], cfg.xmax[0]
        xlo, xhi = cfg.xmin[1], cfg.xmax[1]
        range_y, range_x = yhi - ylo, xhi - xlo
        lam = 0.125 * range_y
        amp = 0.75 * np.sqrt(K_B * 1.0e4 / M_P)
        x0 = xlo + 0.12 * range_x
        sig = 0.05 * range_x
        P[VY] = (amp * np.sin(2.0 * np.pi * (Y + 0.5 * range_y) / lam)
                 * np.exp(-0.5 * ((X - x0) / sig) ** 2))
    return P


def _dtype_front_states(rho0: float, vel0: float, vel2: float,
                        t_neutral: float, t_ionized: float):
    """Solve the three-region planar D-type front structure
    (StarBench_test.cpp:348-437): upstream neutral gas, shocked neutral
    shell, downstream ionized exhaust, from isothermal jump conditions.

    Returns (d_up, v_up, d_sh, v_sh, d_dn, v_dn, c_n, c_i).
    """
    # isothermal sound speeds of pure H: c^2 = p/rho = (1+x) kB T / m_H
    c_n = np.sqrt(K_B * t_neutral / M_P)           # neutral, x=0
    c_i = np.sqrt(2.0 * K_B * t_ionized / M_P)     # ionized, x=1
    v_x = vel0           # velocity into the shock, shock frame
    d_up = rho0
    v_dn = vel2
    # shell density from isothermal shock jump: rho_sh = rho_0 M^2
    d_sh = d_up * (v_x / c_n) ** 2
    # shell velocity from the quadratic (momentum+mass across the IF)
    disc = (v_dn ** 4 + 2.0 * (c_i * v_dn) ** 2 + c_i ** 4
            - 4.0 * (c_n * v_dn) ** 2)
    v_sh = (0.5 / v_dn) * (v_dn ** 2 + c_i ** 2 - np.sqrt(disc))
    # upstream velocity from the shock speed c_n^2/v_x - v_sh
    v_up = v_x - (c_n ** 2 / v_x - v_sh)
    # downstream density from continuity across the IF
    d_dn = d_sh * v_sh / v_dn
    return d_up, v_up, d_sh, v_sh, d_dn, v_dn, c_n, c_i


def planar_if(cfg: SimConfig, rho0: float, vel0: float, vel2: float,
              flux: float, shell_thickness: float = 10.0,
              t_neutral: float = 100.0, t_ionized: float = 1.0e4,
              x_if: float | None = None,
              perturbation: str | int = "none") -> np.ndarray:
    """StarBench_IFI_V2 planar ionization front
    (StarBench_test.cpp:323-722).

    Builds the steady three-region structure (ionized exhaust | shocked
    neutral shell | upstream neutral flow, flowing in -x with the source
    shining from -x), then optionally seeds one of the perturbations:

    - ``"velocity"`` (1): upstream vy ripple, amplitude 0.75 c_n.
    - ``"deformation"`` (2): multi-mode corrugation of IF+shock position,
      volume-fraction antialiased on a 4x4 subgrid per cell.
    - ``"def_small"`` (3): single-mode small corrugation, same scheme.
    - ``"density"`` (4): upstream density ripple, 10% amplitude.

    ``flux`` is the source ionizing photon flux [photons/cm^2/s]; the
    initial IF position is where that flux is absorbed by
    recombinations in the exhaust: x_IF = sqrt(v_x/c_i) F / R_rec.
    """
    from ..microphysics import tables as TB

    d_up, v_up, d_sh, v_sh, d_dn, v_dn, c_n, c_i = _dtype_front_states(
        rho0, vel0, vel2, t_neutral, t_ionized)

    ndim = cfg.ndim
    xlo = cfg.xmin[-1]
    xhi = cfg.xmax[-1]
    range_x = xhi - xlo
    dx = (xhi - xlo) / cfg.shape[-1]

    if x_if is None:
        # recombination rate [1/cm^3/s] of the fully-ionized exhaust at
        # T_ionized; length to absorb flux F is F / R.
        n_dn = d_dn / M_P
        alpha = float(TB.hii_rad_recomb_rate(np.array([t_ionized]))[0])
        rrate = alpha * n_dn * n_dn
        x_if = np.sqrt(vel0 / c_i) * flux / rrate + xlo
    shock_pos = x_if + shell_thickness * dx

    grids = _mesh(cfg)
    X = grids[-1]
    Y = grids[0] if ndim > 1 else None

    def _temp_pressure(rho, x_ion, T):
        return rho / M_P * (1.0 + x_ion) * K_B * T

    P = _blank(cfg)
    dn = X <= x_if
    sh = (X > x_if) & (X <= shock_pos)
    P[RO] = np.where(dn, d_dn, np.where(sh, d_sh, d_up))
    P[VX] = np.where(dn, -v_dn, np.where(sh, -v_sh, -v_up))
    P[PG] = np.where(dn, _temp_pressure(d_dn, 1.0, t_ionized),
                     np.where(sh, _temp_pressure(d_sh, 0.0, t_neutral),
                              _temp_pressure(d_up, 0.0, t_neutral)))
    _set_tracers(P, cfg, np.where(dn, 1.0, 1.0e-12))

    pmap = {"none": 0, "velocity": 1, "deformation": 2, "def_small": 3,
            "density": 4}
    ptype = pmap.get(perturbation, perturbation)
    if ptype == 0:
        return P

    assert ndim == 2, "planar_if perturbations are 2D"
    ylo, yhi = cfg.xmin[0], cfg.xmax[0]
    range_y = yhi - ylo

    if ptype == 1:
        lam = 0.125 * range_y
        amp = 0.75 * c_n
        x0 = shock_pos + 0.2 * range_x
        sig = 0.05 * range_x
        P[VY] = (amp * np.sin(2.0 * np.pi * (Y + 0.5 * range_y) / lam)
                 * np.exp(-0.5 * ((X - x0) / sig) ** 2))
    elif ptype in (2, 3):
        # corrugated IF and shock: per-cell volume fractions of the three
        # phases on a 4x4 subcell grid (antialiasing the curved fronts)
        if ptype == 2:
            shock_pos = x_if + range_y / 64.0
            amp = range_y / 1280.0
            phs = 6.0
            modes = (13.0, 59.0, 131.0, 199.0)
        else:
            amp = range_y / 128.0
            phs = 0.0
            modes = None
        nsub = 4
        sub = (np.arange(nsub) + 0.5) / nsub - 0.5  # offsets in units of dx
        f_dn = np.zeros(cfg.shape)
        f_sh = np.zeros(cfg.shape)
        for oy in sub:
            ys = Y + oy * dx
            if modes is not None:
                defl = sum(amp * np.sin(2.0 * np.pi * m *
                                        ((ys - phs * 0.5 * dx) / range_y + 0.5))
                           for m in modes)
            else:
                defl = amp * np.sin(2.0 * np.pi * (ys + 0.5 * range_y)
                                    / range_y)
            for ox in sub:
                xs = X + ox * dx
                f_dn += (xs <= x_if + defl)
                f_sh += (xs > x_if + defl) & (xs <= shock_pos + defl)
        f_dn /= nsub * nsub
        f_sh /= nsub * nsub
        f_up = 1.0 - f_dn - f_sh
        P[RO] = d_dn * f_dn + d_sh * f_sh + d_up * f_up
        P[VX] = -(v_dn * f_dn + v_sh * f_sh + v_up * f_up)
        P[VY] = 0.0
        xion = 1.0 * f_dn + 1.0e-12 * (f_sh + f_up)
        _set_tracers(P, cfg, xion)
        # reference resets the whole perturbed region to T_neutral
        P[PG] = P[RO] / M_P * (1.0 + xion) * K_B * t_neutral
    elif ptype == 4:
        # density ripple upstream of the (shell-less) front
        n_dn = d_dn / M_P
        alpha = float(TB.hii_rad_recomb_rate(np.array([t_ionized]))[0])
        x_if4 = 0.65 * flux / (alpha * n_dn * n_dn) + xlo
        centre = xlo + 0.75 * range_x
        sigma = 0.05 * range_x
        lam = range_y
        deltarho = (0.1 * np.sin(2.0 * np.pi * (Y + 0.5 * range_y) / lam)
                    * np.exp(-0.5 * ((X - centre) / sigma) ** 2))
        dn = X <= x_if4
        P[RO] = np.where(dn, d_dn, d_up * (1.0 + deltarho))
        P[VX] = np.where(dn, -v_dn, -v_up)
        P[VY] = 0.0
        P[PG] = np.where(dn, _temp_pressure(d_dn, 1.0, t_ionized),
                         P[RO] / M_P * K_B * t_neutral)
        _set_tracers(P, cfg, np.where(dn, 1.0, 1.0e-12))
    else:
        raise ValueError(f"unknown perturbation {perturbation!r}")
    return P


def irradiated_cloud(cfg: SimConfig, profile: str = "uniform") -> np.ndarray:
    """StarBench_IrrCloud_Uniform / _IsoSph (StarBench_test.cpp:777-857).

    Ambient pure-H medium n=50 cm^-3 at 1000 K.  A cloud centred at
    x=1.92 pc (y=z=0): either a uniform-density sphere of radius 1 pc
    with n=1000 cm^-3, or a cutoff isothermal sphere
    rho = rho_c r_c^2/(r_c^2+d^2) with r_c=0.5 pc (floored at ambient).
    """
    P = _blank(cfg)
    P[RO] = 50.0 * M_P
    P[PG] = 50.0 * K_B * 1000.0
    _set_tracers(P, cfg, 0.0)

    grids = _mesh(cfg)
    centre = [0.0] * cfg.ndim
    centre[-1] = 1.92 * PARSEC
    d2 = sum((grids[i] - centre[i]) ** 2 for i in range(cfg.ndim))
    rho_cl = 1000.0 * M_P
    if profile == "uniform":
        P[RO] = np.where(d2 < PARSEC ** 2, rho_cl, P[RO])
    elif profile == "isosph":
        r_core = 0.5 * PARSEC
        rho_cell = rho_cl * r_core ** 2 / (r_core ** 2 + d2)
        P[RO] = np.maximum(P[RO], rho_cell)
    else:
        raise ValueError(f"profile must be 'uniform' or 'isosph': {profile}")
    return P


def tremblin_cooling(cfg: SimConfig, nH: float = 0.5) -> np.ndarray:
    """StarBench_TremblinCooling shadowing/mixing/cooling test
    (StarBench_test.cpp:864-897): uniform fully-ionized pure-H gas with
    n(H)=``nH`` cm^-3 at 10^4 K (pg = 2 n kB T, electrons included)."""
    P = _blank(cfg)
    P[RO] = nH * M_P
    P[PG] = 2.0 * nH * K_B * 1.0e4
    _set_tracers(P, cfg, 1.0)
    return P


def cone(cfg: SimConfig, src_pos=(0.0, 0.0), r0: float = 3.086e17,
         radial_slope: float = 2.0) -> np.ndarray:
    """StarBench_Cone photoevaporating cone (StarBench_test.cpp:909-959).

    2D axisymmetric (R, z): neutral pure-H core n=10^4 cm^-3 at 100 K
    inside radius ``r0`` of the source, with an isothermal power-law
    envelope rho ~ (r0/r)^slope modulated by (1 - 0.25 cos theta),
    theta measured from the +z axis at the source (Iliev+09 test 6
    geometry with an angular tilt).
    """
    assert cfg.ndim == 2, "Cone test is 2D axisymmetric (R,z)"
    R, Z = _mesh(cfg)  # array order (R, z); PION x-axis == z
    zs, rs = src_pos[-1], src_pos[0] if len(src_pos) > 1 else 0.0
    theta = np.arctan2(R - rs, Z - zs)
    dist = np.sqrt((Z - zs) ** 2 + (R - rs) ** 2)

    P = _blank(cfg)
    rho0 = 1.0e4 * M_P
    pg0 = 1.518e-10  # 100 K neutral pure H at n=1e4 (reference value)
    fac = np.where(dist > r0,
                   np.exp(radial_slope * np.log(r0 / np.maximum(dist, 1e-30)))
                   * (1.0 - 0.25 * np.cos(theta)),
                   1.0)
    P[RO] = rho0 * fac
    P[PG] = pg0 * fac
    _set_tracers(P, cfg, 1.0e-12)
    return P
