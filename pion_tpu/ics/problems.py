"""Additional problem generators from the icgen menu.

Reference: source/ics/icgen_base.cpp:36-130 dispatch; individual generators
in source/ics/ (basic_tests.cpp, jet.cpp, shock_cloud.cpp, clump tests,
double_Mach_reflection via DMR BCs, Liska & Wendroff implosion).
"""
from __future__ import annotations

import numpy as np

from ..config import SimConfig
from ..constants import BX, BY, BZ, PG, RO, VX, VY, VZ


def _mesh(cfg: SimConfig):
    coords = [cfg.cell_centers(ax) for ax in range(cfg.ndim)]
    return np.meshgrid(*coords, indexing="ij")


def kelvin_helmholtz(cfg: SimConfig, rho1=1.0, rho2=2.0, v1=0.5, v2=-0.5,
                     p0=2.5, amp=0.01, seed=7) -> np.ndarray:
    """2D KH instability: shear layer at |y-0.5|=0.25 with velocity
    perturbation (reference: icgen KelvinHelmholz setups)."""
    assert cfg.ndim == 2
    Y, X = _mesh(cfg)
    P = np.zeros((cfg.nvar,) + cfg.shape)
    inner = np.abs(Y - 0.5) < 0.25
    P[RO] = np.where(inner, rho2, rho1)
    P[VX] = np.where(inner, v2, v1)
    P[PG] = p0
    P[VY] = amp * np.sin(4.0 * np.pi * X)
    for tr in range(cfg.eqn.nbase, cfg.nvar):
        P[tr] = inner.astype(float)
    return P


def liska_wendroff_implosion(cfg: SimConfig) -> np.ndarray:
    """Liska & Wendroff (2003) implosion: diagonal discontinuity in the
    unit box, reflecting walls; the solution must remain symmetric about
    the diagonal (reference test_problems LWimplosion)."""
    assert cfg.ndim == 2
    Y, X = _mesh(cfg)
    P = np.zeros((cfg.nvar,) + cfg.shape)
    inside = (X + Y) < 0.15
    P[RO] = np.where(inside, 0.125, 1.0)
    P[PG] = np.where(inside, 0.14, 1.0)
    return P


def double_mach_reflection(cfg: SimConfig) -> np.ndarray:
    """Woodward & Colella (1984) double Mach reflection IC: Mach-10 shock
    inclined 60 degrees, crossing the bottom wall at x=1/6
    (reference: double_Mach_ref_boundaries.cpp states; gamma=1.4)."""
    assert cfg.ndim == 2
    from ..boundaries import DMR_POST, DMR_PRE

    Y, X = _mesh(cfg)
    P = np.zeros((cfg.nvar,) + cfg.shape)
    bpos = 1.0 / 6.0 + Y / np.tan(np.pi / 3.0)
    post = X <= bpos
    for v in range(5):
        P[v] = np.where(post, DMR_POST[v], DMR_PRE[v])
    for tr in range(cfg.eqn.nbase, cfg.nvar):
        P[tr] = np.where(post, 1.0, -1.0)
    return P


def jet_ambient(cfg: SimConfig, rho_amb=1.0, p_amb=1.0) -> np.ndarray:
    """Uniform ambient medium for jet simulations; the jet enters through
    a BC.JET face (reference: ics/jet.cpp + jet_boundaries.cpp)."""
    P = np.zeros((cfg.nvar,) + cfg.shape)
    P[RO] = rho_amb
    P[PG] = p_amb
    return P


def jet_state(cfg: SimConfig, rho_jet=0.1, p_jet=1.0, v_jet=10.0,
              tracer=1.0) -> np.ndarray:
    """Jet inflow primitive vector for BoundaryData.jet."""
    s = np.zeros(cfg.nvar)
    s[RO] = rho_jet
    s[PG] = p_jet
    s[VX] = v_jet
    for tr in range(cfg.eqn.nbase, cfg.nvar):
        s[tr] = tracer
    return s


def shock_cloud(cfg: SimConfig, mach=10.0, rho_amb=1.0, p_amb=1.0,
                rho_cloud=10.0, r_cloud=0.15, x_shock=0.3,
                cloud_center=None, gamma=None) -> np.ndarray:
    """Planar shock hitting a dense spherical cloud
    (reference: ics/shock_cloud.cpp)."""
    g = gamma or cfg.gamma
    grids = _mesh(cfg)
    P = np.zeros((cfg.nvar,) + cfg.shape)
    x = grids[-1]
    if cloud_center is None:
        cloud_center = [0.5 * (cfg.xmin[i] + cfg.xmax[i])
                        for i in range(cfg.ndim)]
        cloud_center[-1] = x_shock + 2.0 * r_cloud
    r2 = sum((grids[i] - cloud_center[i]) ** 2 for i in range(cfg.ndim))
    cloud = r2 < r_cloud * r_cloud

    # Rankine-Hugoniot post-shock state for a Mach `mach` shock moving in +x
    m2 = mach * mach
    rho_ratio = (g + 1.0) * m2 / ((g - 1.0) * m2 + 2.0)
    p_ratio = (2.0 * g * m2 - (g - 1.0)) / (g + 1.0)
    cs = np.sqrt(g * p_amb / rho_amb)
    v_post = mach * cs * (1.0 - 1.0 / rho_ratio)

    pre = x >= x_shock
    P[RO] = np.where(pre, rho_amb, rho_amb * rho_ratio)
    P[PG] = np.where(pre, p_amb, p_amb * p_ratio)
    P[VX] = np.where(pre, 0.0, v_post)
    P[RO] = np.where(cloud, rho_cloud, P[RO])
    for tr in range(cfg.eqn.nbase, cfg.nvar):
        P[tr] = cloud.astype(float)
    return P


def spherical_clump(cfg: SimConfig, rho_amb=1.0, p_amb=1.0, rho_max=100.0,
                    r_core=0.1, center=None, profile="gaussian",
                    B0=None, v0=None) -> np.ndarray:
    """Dense clump in a uniform medium: Gaussian or top-hat profile.

    Covers both ``Clump_Spherical`` (1D spherical, centre at r=0) and
    ``Clump_Axisymmetric`` (2D cylindrical, centre on axis) — same fill,
    the coordinate system comes from cfg (reference:
    ics/spherical_clump.cpp:125-133 dispatch, :153-220 setup_clump; the
    reference's uniform SC_BX/BY/BZ field and ambient velocity are the
    ``B0``/``v0`` tuples here)."""
    grids = _mesh(cfg)
    if center is None:
        center = [0.5 * (cfg.xmin[i] + cfg.xmax[i]) for i in range(cfg.ndim)]
    r2 = sum((grids[i] - center[i]) ** 2 for i in range(cfg.ndim))
    P = np.zeros((cfg.nvar,) + cfg.shape)
    if profile == "gaussian":
        P[RO] = rho_amb + (rho_max - rho_amb) * np.exp(-r2 / (2 * r_core**2))
    else:
        P[RO] = np.where(r2 < r_core**2, rho_max, rho_amb)
    P[PG] = p_amb
    if v0 is not None:
        for k, v in enumerate(v0[:3]):
            P[VX + k] = v
    if B0 is not None and cfg.eqn.is_mhd:
        for k, b in enumerate(B0[:3]):
            P[BX + k] = b
    for tr in range(cfg.eqn.nbase, cfg.nvar):
        P[tr] = np.clip((P[RO] - rho_amb) / (rho_max - rho_amb), 0, 1)
    return P


def random_clumps(cfg: SimConfig, n_clumps=10, rho_amb=1.0, p_amb=1.0,
                  rho_max=50.0, r_core=0.05, seed=42) -> np.ndarray:
    """Multiple randomly-placed Gaussian clumps
    (reference: ics/photevap_multi_clumps.cpp RandomClumps)."""
    rng = np.random.default_rng(seed)
    grids = _mesh(cfg)
    P = np.zeros((cfg.nvar,) + cfg.shape)
    P[RO] = rho_amb
    P[PG] = p_amb
    for _ in range(n_clumps):
        center = [rng.uniform(cfg.xmin[i] + 0.1 * (cfg.xmax[i] - cfg.xmin[i]),
                              cfg.xmax[i] - 0.1 * (cfg.xmax[i] - cfg.xmin[i]))
                  for i in range(cfg.ndim)]
        r2 = sum((grids[i] - center[i]) ** 2 for i in range(cfg.ndim))
        P[RO] += (rho_max - rho_amb) * np.exp(-r2 / (2 * r_core**2))
    for tr in range(cfg.eqn.nbase, cfg.nvar):
        P[tr] = np.clip((P[RO] - rho_amb) / (rho_max - rho_amb), 0, 1)
    return P


def _clump_mass_to_peak(mass, r_core, profile, ndim):
    """Peak overdensity for a clump of given total mass.

    Gaussian: M = rho_peak * (2 pi)^{d/2} r_core^d; top-hat: M = rho * V
    (reference: photoevaporating_multiclumps.cpp:1112-1127 sets mass from
    profile the same way, inverted here)."""
    if profile == "gaussian":
        return mass / ((2.0 * np.pi) ** (0.5 * ndim) * r_core**ndim)
    vol = {1: 2.0, 2: np.pi, 3: 4.0 * np.pi / 3.0}[ndim] * r_core**ndim
    return mass / vol


def multi_clumps(cfg: SimConfig, mode="fixnum", n_clumps=10, total_mass=None,
                 mass_range=(0.5, 2.0), r_range=(0.03, 0.08),
                 rho_amb=1.0, p_amb=1.0, profile="gaussian",
                 region=(0.2, 0.8), radial_slope=0.0, cloud_center=None,
                 cloud_radius=None, strategic=(), seed=7) -> np.ndarray:
    """PhotEvap_MultiClumps_FixNum / _FixMass + strategic clumps.

    JAX re-derivation of the multi-clump generator (reference:
    ics/photoevaporating_multiclumps.cpp: get_random_clump_params draws
    either a fixed number of clumps with random masses [FixNum, :756-800]
    or keeps drawing until a total mass budget is spent [FixMass,
    :800-840]; strategic clumps at caller-given positions :1009-1148;
    optional power-law ambient profile about the cloud centre :495-510).

    ``strategic``: sequence of (center, mass, r_core) placed exactly.
    ``region``: fractional sub-box that random clump centres occupy.
    """
    rng = np.random.default_rng(seed)
    grids = _mesh(cfg)
    nd = cfg.ndim
    P = np.zeros((cfg.nvar,) + cfg.shape)

    # ambient medium, optionally with a power-law radial profile
    rho_bg = np.full(cfg.shape, rho_amb)
    if radial_slope != 0.0:
        if cloud_center is None:
            cloud_center = [cfg.xmin[i] for i in range(nd)]
        if cloud_radius is None:
            cloud_radius = 0.25 * (cfg.xmax[0] - cfg.xmin[0])
        dist = np.sqrt(sum((grids[i] - cloud_center[i]) ** 2
                           for i in range(nd)))
        dist = np.maximum(dist, cloud_radius)
        rho_bg = rho_amb * (cloud_radius / dist) ** radial_slope
    P[RO] = rho_bg
    P[PG] = p_amb * rho_bg / rho_amb  # isothermal ambient

    lo = [cfg.xmin[i] + region[0] * (cfg.xmax[i] - cfg.xmin[i])
          for i in range(nd)]
    hi = [cfg.xmin[i] + region[1] * (cfg.xmax[i] - cfg.xmin[i])
          for i in range(nd)]

    def draw():
        c = [rng.uniform(lo[i], hi[i]) for i in range(nd)]
        m = rng.uniform(*mass_range)
        r = rng.uniform(*r_range)
        return c, m, r

    clumps = []
    if mode == "fixnum":
        clumps = [draw() for _ in range(n_clumps)]
    elif mode == "fixmass":
        assert total_mass is not None, "fixmass mode needs total_mass"
        remaining = float(total_mass)
        while remaining > mass_range[0]:
            c, m, r = draw()
            m = min(m, remaining)
            clumps.append((c, m, r))
            remaining -= m
    else:
        raise ValueError(f"unknown multi_clumps mode {mode!r}")
    clumps.extend(strategic)

    overdens = np.zeros(cfg.shape)
    for center, mass, r_core in clumps:
        r2 = sum((grids[i] - center[i]) ** 2 for i in range(nd))
        peak = _clump_mass_to_peak(mass, r_core, profile, nd)
        if profile == "gaussian":
            overdens += peak * np.exp(-r2 / (2 * r_core**2))
        else:
            overdens += np.where(r2 < r_core**2, peak, 0.0)
    P[RO] = P[RO] + overdens
    for tr in range(cfg.eqn.nbase, cfg.nvar):
        P[tr] = np.clip(overdens / (overdens.max() + 1e-300), 0, 1)
    return P


def photoevap_cloudclump(cfg: SimConfig, rho_amb=1.0, p_amb=1.0,
                         cloud_center=None, cloud_radius=0.3,
                         rho_cloud=10.0, clump_offset=None,
                         clump_radius=0.08, rho_clump=100.0) -> np.ndarray:
    """PhotoEvap_CloudClump: a smooth cloud with one embedded dense clump
    (reference: ics/photoevaporating_clump.cpp:265-268 PE_CLOUD_CLUMP).
    The cloud is a top-hat + Gaussian edge; the clump a Gaussian inside."""
    grids = _mesh(cfg)
    nd = cfg.ndim
    if cloud_center is None:
        cloud_center = [cfg.xmin[i] + 0.35 * (cfg.xmax[i] - cfg.xmin[i])
                        for i in range(nd)]
    if clump_offset is None:
        clump_offset = [0.0] * nd
    P = np.zeros((cfg.nvar,) + cfg.shape)
    r = np.sqrt(sum((grids[i] - cloud_center[i]) ** 2 for i in range(nd)))
    edge = np.exp(-np.maximum(r - cloud_radius, 0.0) ** 2
                  / (2 * (0.1 * cloud_radius) ** 2))
    cloud = np.where(r <= cloud_radius, 1.0, edge)
    r2c = sum((grids[i] - cloud_center[i] - clump_offset[i]) ** 2
              for i in range(nd))
    clump = np.exp(-r2c / (2 * clump_radius**2))
    P[RO] = rho_amb + (rho_cloud - rho_amb) * cloud + rho_clump * clump
    P[PG] = p_amb
    for tr in range(cfg.eqn.nbase, cfg.nvar):
        P[tr] = np.clip((P[RO] - rho_amb) / (rho_clump - rho_amb), 0, 1)
    return P


def add_noise(P: np.ndarray, cfg: SimConfig, amplitude: float,
              seed: int = 0, kind: str = "pressure") -> np.ndarray:
    """Random perturbations like icgen's AddNoise2Data
    (reference: ics/icgen.cpp:257 noise options)."""
    rng = np.random.default_rng(seed)
    out = P.copy()
    noise = 1.0 + amplitude * (rng.random(P[0].shape) - 0.5)
    if kind == "pressure":
        out[PG] *= noise
    elif kind == "density":
        out[RO] *= noise
    return out


def laser_ablation(cfg: SimConfig, vel0=0.0, rho0=1.0, dratio=100.0,
                   p0=1.0, pratio=100.0, bx0=0.0, bt0=0.0) -> np.ndarray:
    """Laser-ablation slab: dense driver for x<0.0025 cm, linear ramp over
    y in [0.04, 0.06] cm, dilute ambient elsewhere (reference:
    ics/laser_ablation.cpp:169-233 setup_LaserAblationAxi; the 3D variant
    is an empty stub upstream, :240).  Axes: x = symmetry axis (fast/last),
    y = cylindrical radius (first)."""
    assert cfg.ndim == 2
    Y, X = _mesh(cfg)
    r1 = rho0 / dratio
    p1 = p0 / pratio
    P = np.zeros((cfg.nvar,) + cfg.shape, cfg.np_dtype)
    slab = X < 0.0025
    ramp = slab & (Y >= 0.04) & (Y < 0.06)
    core = slab & (Y < 0.04)
    P[RO] = np.where(core, rho0,
                     np.where(ramp, rho0 + 50.0 * (r1 - rho0) * (Y - 0.04),
                              r1))
    P[PG] = np.where(core, p0,
                     np.where(ramp, p0 + 50.0 * (p1 - p0) * (Y - 0.04), p1))
    P[VX] = vel0
    if cfg.eqn.is_mhd:
        P[BX] = bx0
        P[BY] = bt0
    if cfg.ntracer:
        P[cfg.tracer_slice.start] = np.where(slab, 1.0, 0.0)
    return P


def map_1d_to_2d(radius: np.ndarray, data: np.ndarray,
                 cfg2d: SimConfig) -> np.ndarray:
    """Map a 1D spherical profile onto a 2D axisymmetric grid (reference:
    ics/read_1Dto2D.cpp get_data_vals: linear radial interpolation, VX of
    the profile is the radial velocity, projected onto (z, R); MHD gets a
    uniform weak 1e-8 G x-field, :61-75)."""
    assert cfg2d.ndim == 2
    nvar1 = data.shape[0]
    Y, X = _mesh(cfg2d)   # Y = R_cyl, X = z (the symmetry axis)
    r = np.sqrt(X * X + Y * Y)
    r = np.maximum(r, 1.0e-12 * radius.max())
    P = np.zeros((cfg2d.nvar,) + cfg2d.shape, cfg2d.np_dtype)
    for v in range(min(nvar1, cfg2d.nvar)):
        P[v] = np.interp(r, radius, data[v])
    vr = P[VX].copy()
    P[VX] = vr * X / r
    P[VY] = vr * Y / r
    P[VZ] = 0.0
    if cfg2d.eqn.is_mhd:
        P[BX] = 1.0e-8
        P[BY] = 0.0
        P[BZ] = 0.0
    return P


def from_turbulence_cube(cfg: SimConfig, rho_cube: np.ndarray,
                         v_cubes=None, rho_mean=1.0, p0=1.0,
                         v_rms=0.0) -> np.ndarray:
    """Initial conditions from a (periodic) turbulence data cube — the
    capability equivalent of the reference's ReadBBTurbulence generator
    (reference: icgen_base.cpp dispatch + contrib/ Burkhart-cube shock-cloud
    setups), generalized to accept ANY cube: the density (and optional
    velocity) cubes are trilinearly resampled onto the grid, density is
    rescaled to ``rho_mean`` and velocities to the requested rms."""
    nd = cfg.ndim
    assert rho_cube.ndim == nd
    grids = np.meshgrid(*[np.linspace(0.0, s - 1.0, n)
                          for s, n in zip(rho_cube.shape, cfg.shape)],
                        indexing="ij")

    def resample(cube):
        from scipy.ndimage import map_coordinates
        return map_coordinates(cube, np.stack([g.ravel() for g in grids]),
                               order=1, mode="wrap").reshape(cfg.shape)

    try:
        rho = resample(rho_cube)
        vs = [resample(v) for v in (v_cubes or [])]
    except ImportError:  # no scipy: nearest-neighbor fallback
        idx = tuple(np.clip(np.round(g).astype(int), 0, s - 1)
                    for g, s in zip(grids, rho_cube.shape))
        rho = rho_cube[idx]
        vs = [v[idx] for v in (v_cubes or [])]
    rho = rho * (rho_mean / rho.mean())
    P = np.zeros((cfg.nvar,) + cfg.shape, cfg.np_dtype)
    P[RO] = rho
    P[PG] = p0
    if vs:
        rms = np.sqrt(np.mean(sum(v * v for v in vs)))
        scale = v_rms / rms if rms > 0 else 0.0
        # cube axis order (z,y,x...) matches array order; VX is last axis
        for k, v in enumerate(vs):
            P[VX + k] = v * scale if k < 3 else P[VX + k]
    return P


def radiative_shock(cfg: SimConfig, vsh=1.0e7, rho0=1.0e-22, T0=1.0e4,
                    B0=0.0, x_ion=0.101, mu=1.27,
                    tracers=None) -> np.ndarray:
    """Radiative shock: fast cold flow onto a reflecting wall
    (reference: ics/radiative_shock.cpp setup_RadiativeShock :151-192).

    Uniform gas of density ``rho0`` at temperature ``T0`` flows in -x
    at the shock speed ``vsh``; the wall (x=0 reflecting BC) launches
    the radiative shock.  ``mu`` is the mean mass per particle in
    proton masses; pg = rho (1+x) kB T / (mu m_p).  ``B0`` sets a
    transverse By for the MHD variant.
    """
    from ..constants import K_B, M_P

    P = np.zeros((cfg.nvar,) + cfg.shape)
    P[RO] = rho0
    P[PG] = rho0 * (1.0 + x_ion) * K_B * T0 / (mu * M_P)
    P[VX] = -vsh
    if cfg.eqn.nbase > 5 and B0 != 0.0:
        P[BY] = B0
    ftr = cfg.eqn.nbase
    for t in range(ftr, cfg.nvar):
        P[t] = 0.5 if tracers is None else tracers[t - ftr]
    return P


def radiative_shock_outflow(cfg: SimConfig, vsh=1.0e7, rho0=1.0e-22,
                            T0=1.0e4, mu=1.22, divisor=3.0,
                            tr_up=None, tr_dn=None) -> np.ndarray:
    """RadiativeShockOutflow: shock near the low-x outflow boundary
    (reference: ics/radiative_shock.cpp setup_OutflowRadiativeShock
    :201-300): upstream gas flows in -x onto a dense slab (isothermal
    jump rho1 = rho0 M^2 / divisor) occupying the low-x fifth of the
    domain, with a linear velocity ramp across a thin interface."""
    from ..constants import K_B, M_P

    xlo, xhi = cfg.xmin[-1], cfg.xmax[-1]
    xboundary = (xhi - xlo) / 5.0
    if vsh <= 1.01e7:
        xboundary *= 2.5
    ramp = (xhi - xlo) * 5.0 / cfg.shape[-1]

    pg = rho0 * K_B * T0 / (mu * M_P)
    mach0 = vsh / np.sqrt(cfg.gamma * pg / rho0)
    rho1 = rho0 * mach0 * mach0 / divisor
    pg1 = rho1 * K_B * T0 / (mu * M_P)

    grids = np.meshgrid(*[cfg.cell_centers(ax) for ax in range(cfg.ndim)],
                        indexing="ij")
    X = grids[-1] - xlo
    P = np.zeros((cfg.nvar,) + cfg.shape)
    up = X >= xboundary + ramp
    dn = X <= xboundary
    mid = ~up & ~dn
    frac = np.clip((X - xboundary) / ramp, 0.0, 1.0)
    P[RO] = np.where(up, rho0, np.where(dn, rho1, rho1 + frac * (rho0 - rho1)))
    P[PG] = np.where(up, pg, np.where(dn, pg1, pg1 + frac * (pg - pg1)))
    P[VX] = np.where(up, -vsh, np.where(dn, 0.0, -vsh * frac))
    ftr = cfg.eqn.nbase
    for t in range(ftr, cfg.nvar):
        u = 0.0 if tr_up is None else tr_up[t - ftr]
        d = 0.0 if tr_dn is None else tr_dn[t - ftr]
        P[t] = np.where(up, u, np.where(dn, d, d + frac * (u - d)))
    return P


def photoevaporating_clump(cfg: SimConfig, ambient, dratio=1.0, pratio=1.0,
                           bratio=1.0, cloud_tracers=(), radius=0.1,
                           center=None) -> np.ndarray:
    """I-front hitting a circular/spherical cloud: ambient state everywhere,
    inside ``radius`` of ``center`` density*=dratio, pressure*=pratio,
    Bx*=bratio and tracers set to ``cloud_tracers`` (reference:
    ics/photoevaporating_clump.cpp:500-532 setup_pec — the sub-cell
    inside_sphere volume fraction becomes a one-cell linear edge ramp
    here).  RCW120-class configs use dratio=1 with pratio>1: a pure
    pressure/ionisation cloud."""
    grids = _mesh(cfg)
    if center is None:
        center = [0.5 * (cfg.xmin[i] + cfg.xmax[i]) for i in range(cfg.ndim)]
    d = np.sqrt(sum((grids[i] - center[i]) ** 2 for i in range(cfg.ndim)))
    # ~volume fraction of the cell inside the sphere (linear over one cell)
    vfrac = np.clip((radius - d) / cfg.dx + 0.5, 0.0, 1.0)
    ambient = np.asarray(ambient, dtype=float)
    P = np.broadcast_to(
        ambient.reshape((-1,) + (1,) * cfg.ndim),
        (cfg.nvar,) + cfg.shape).copy()
    P[RO] *= 1.0 + (dratio - 1.0) * vfrac
    P[PG] *= 1.0 + (pratio - 1.0) * vfrac
    if cfg.eqn.is_mhd:
        P[BX] *= 1.0 + (bratio - 1.0) * vfrac
    for v in range(cfg.ntracer):
        tr = cfg.eqn.nbase + v
        cl = cloud_tracers[v] if v < len(cloud_tracers) else 0.0
        P[tr] = vfrac * cl + (1.0 - vfrac) * ambient[tr]
    return P


def photoevap_radial(cfg: SimConfig, ambient, cloud_center,
                     r0, radial_slope=2.0) -> np.ndarray:
    """PhotoEvap_radial: uniform state with an isothermal power-law
    envelope rho,pg ~ (r0/r)^slope for r>r0 from ``cloud_center``
    (reference: ics/photoevaporating_clump.cpp setup_radialprofile
    :680-745, following Iliev et al. 2009 test 6)."""
    grids = np.meshgrid(*[cfg.cell_centers(ax) for ax in range(cfg.ndim)],
                        indexing="ij")
    dist = np.sqrt(sum((grids[i] - cloud_center[i]) ** 2
                       for i in range(cfg.ndim)))
    P = np.zeros((cfg.nvar,) + cfg.shape)
    for v in range(cfg.nvar):
        P[v] = ambient[v]
    fac = np.where(dist > r0, (r0 / np.maximum(dist, 1e-30)) ** radial_slope,
                   1.0)
    P[RO] *= fac
    P[PG] *= fac
    return P


def photoevap_powerlaw(cfg: SimConfig, ambient, rho0=9.352e-23,
                       x0=3.086e18, xoffset=12.344e18,
                       slope=3.0) -> np.ndarray:
    """PhotoEvap_powerlaw: ambient state with rho = rho0 ((x+xoffset)/x0)^slope
    along the x-axis (reference: ics/photoevaporating_clump.cpp
    setup_powerlaw_density :541-580)."""
    grids = np.meshgrid(*[cfg.cell_centers(ax) for ax in range(cfg.ndim)],
                        indexing="ij")
    X = grids[-1]
    P = np.zeros((cfg.nvar,) + cfg.shape)
    for v in range(cfg.nvar):
        P[v] = ambient[v]
    P[RO] = rho0 * ((X + xoffset) / x0) ** slope
    return P


def photoevap_paralleltest(cfg: SimConfig, ambient,
                           factor=1.1) -> np.ndarray:
    """PhotoEvap_paralleltest: ambient state with a geometric density/
    pressure gradient along y — each row ``factor``x its -y neighbour
    (reference: ics/photoevaporating_clump.cpp setup_paralleltest
    :765-790); exercises parallel rays with varying absorption."""
    assert cfg.ndim >= 2
    P = np.zeros((cfg.nvar,) + cfg.shape)
    for v in range(cfg.nvar):
        P[v] = ambient[v]
    ny = cfg.shape[-2]
    grad = factor ** np.arange(ny)
    shp = [1] * cfg.ndim
    shp[-2] = ny
    grad = grad.reshape(shp)
    P[RO] = P[RO] * grad
    P[PG] = P[PG] * grad
    return P


def uniform(cfg: SimConfig, state) -> np.ndarray:
    """Uniform ambient state everywhere (reference: icgen 'Uniform')."""
    P = np.zeros((cfg.nvar,) + cfg.shape)
    for v in range(cfg.nvar):
        P[v] = state[v]
    return P
