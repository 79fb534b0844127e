"""Stellar-wind internal boundary tests.

Gates modeled on the reference Wind2D/Ostar configs: the free-wind region
must maintain rho ~ r^-2 with radial v=v_inf, and the wind must sweep up
an expanding bubble.
"""
import numpy as np
import jax.numpy as jnp

from pion_tpu import Coord, Eqn, SimConfig, Simulation
from pion_tpu.constants import M_P, PG, RO, VX, VY
from pion_tpu.physics import Physics
from pion_tpu.winds import WindEvolution, WindSource

PC = 3.0856775807e18
MSUN_YR = 1.98892e33 / 3.15576e7


def wind_sim(n=64, evolution=None, mdot=1.0e-6 * MSUN_YR):
    rmax = 0.5 * PC
    cfg = SimConfig(
        ndim=2, eqn=Eqn.EULER, solver="hll", coords=Coord.CYLINDRICAL,
        shape=(n // 2, n), xmin=(0.0, -rmax / 2), xmax=(rmax / 2, rmax / 2),
        bcs=(("axisymmetric", "outflow"), ("outflow", "outflow")),
        cfl=0.3, ooa=2, av="falle", etav=0.1, tmax=1.0,
    )
    # ambient ISM
    nH = 100.0
    P0 = np.zeros((cfg.nvar,) + cfg.shape)
    P0[RO] = nH * M_P
    P0[PG] = nH * 1.380649e-16 * 100.0
    src = WindSource(position=(0.0, 0.0), radius=10.0 * rmax / n,
                     mdot=mdot, vinf=2.0e8, t_wind=1.0e4,
                     rstar=7.0e11, evolution=evolution)
    phys = Physics(wind_sources=[src])
    sim = Simulation(cfg, jnp.asarray(P0), physics=phys)
    return sim, src


def test_wind_region_profile():
    sim, src = wind_sim()
    P = np.asarray(sim.P)
    cfg = sim.cfg
    R = cfg.cell_centers(0)
    z = cfg.cell_centers(1)
    RR, ZZ = np.meshgrid(R, z, indexing="ij")
    d = np.hypot(RR, ZZ)
    sel = (d > 0.8 * src.radius) & (d <= src.radius)
    rho_expect = src.mdot / (4.0 * np.pi * src.vinf * d[sel] ** 2)
    np.testing.assert_allclose(P[RO][sel], rho_expect, rtol=1e-10)
    # velocity is radial with magnitude vinf: vx (=v_z) ~ vinf * z/d
    np.testing.assert_allclose(P[VX][sel], src.vinf * ZZ[sel] / d[sel],
                               rtol=1e-10)
    np.testing.assert_allclose(P[VY][sel], src.vinf * RR[sel] / d[sel],
                               rtol=1e-10)


def test_wind_bubble_expands():
    sim, src = wind_sim(mdot=1.0e-5 * MSUN_YR)
    # ~600 yr: the bubble shell must emerge beyond the wind boundary region
    sim.run(tmax=2.0e10, max_steps=800)
    P = np.asarray(sim.P)
    assert np.all(np.isfinite(P))
    cfg = sim.cfg
    R = cfg.cell_centers(0)
    z = cfg.cell_centers(1)
    RR, ZZ = np.meshgrid(R, z, indexing="ij")
    d = np.hypot(RR, ZZ)
    # a shocked shell (density above ambient) must exist beyond the wind region
    ambient = 100.0 * M_P
    shell = (d > src.radius) & (P[RO] > 1.5 * ambient)
    assert shell.sum() > 5, "no swept-up shell formed"
    # free wind inside maintains the r^-2 profile
    sel = (d > 0.8 * src.radius) & (d <= src.radius)
    rho_expect = src.mdot / (4.0 * np.pi * src.vinf * d[sel] ** 2)
    np.testing.assert_allclose(P[RO][sel], rho_expect, rtol=1e-10)


def test_evolving_wind():
    ev = WindEvolution(
        time=np.array([0.0, 1.0e10]),
        mdot=np.array([1.0e-6 * MSUN_YR, 2.0e-6 * MSUN_YR]),
        vinf=np.array([2.0e8, 2.0e8]),
        t_wind=np.array([1.0e4, 1.0e4]),
        rstar=np.array([7.0e11, 7.0e11]),
    )
    sim, src = wind_sim(evolution=ev)
    w = sim.physics.winds[0]
    W0 = np.asarray(w.wind_state(sim.P, 0.0))
    W1 = np.asarray(w.wind_state(sim.P, 1.0e10))
    mask = np.asarray(w.mask) & ~np.asarray(w.inner)
    ratio = W1[RO][mask] / W0[RO][mask]
    np.testing.assert_allclose(ratio, 2.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# Latitude-dependent wind models (reference: stellar_wind_angle/latdep.cpp)
# ---------------------------------------------------------------------------

def test_angle_wind_mass_flux_conserved():
    """The omega-slow-wind density normalisation (fn_delta) must make the
    surface-integrated mass flux equal Mdot at any radius (the property the
    reference's Simpson-integrated delta table enforces)."""
    from pion_tpu.winds import fn_density_angle, fn_v_inf
    mdot, vinf, teff, xi = 1.0e20, 2.0e8, 2.0e4, -0.43
    r = 1.0e13
    th = np.linspace(1e-4, np.pi / 2, 4001)
    for om in (0.1, 0.5, 0.9):
        rho = np.asarray(fn_density_angle(om, vinf, mdot, r, th, teff, xi))
        v = np.asarray(fn_v_inf(om, vinf, th))
        # integrate over the full sphere (symmetric about equator)
        flux = 2.0 * np.trapz(rho * v * 2 * np.pi * r * r * np.sin(th), th)
        np.testing.assert_allclose(flux, mdot, rtol=2e-3)


def test_angle_wind_equatorial_enhancement():
    from pion_tpu.winds import fn_density_angle, fn_v_inf
    mdot, vinf, teff, xi = 1.0e20, 2.0e8, 2.0e4, -0.43
    r = 1.0e13
    om = 0.8
    rho_pole = float(fn_density_angle(om, vinf, mdot, r, 1e-3, teff, xi))
    rho_eq = float(fn_density_angle(om, vinf, mdot, r, np.pi / 2, teff, xi))
    assert rho_eq > 2.0 * rho_pole, "equator must be density-enhanced"
    v_pole = float(fn_v_inf(om, vinf, 1e-3))
    v_eq = float(fn_v_inf(om, vinf, np.pi / 2))
    assert v_pole > v_eq, "polar wind must be faster"


def test_latdep_wind_mass_flux_conserved():
    from pion_tpu.winds import latdep_f, latdep_norm, C_GAMMA
    md0, mdot, vinf, xi = 1.0e20, 3.0e20, 2.0e8, -0.43
    om, r = 0.7, 1.0e13
    th = np.linspace(0.0, np.pi / 2, 4001)
    A = (mdot / md0 - 1.0) / float(latdep_norm(om, xi))
    v = vinf * (1.0 - om * np.sin(th)) ** C_GAMMA
    rho = md0 * (1.0 + A * np.asarray(latdep_f(th, om, xi))) \
        / (4.0 * np.pi * r * r * v)
    flux = 2.0 * np.trapz(rho * v * 2 * np.pi * r * r * np.sin(th), th)
    np.testing.assert_allclose(flux, mdot, rtol=1e-3)


def test_angle_wind_state_on_grid():
    """End-to-end: a lat-dep rotating source fills its region with an
    equator-enhanced wind on a 2D axisymmetric grid."""
    from pion_tpu.constants import RO as iRO
    rmax = 0.5 * PC
    n = 64
    cfg = SimConfig(
        ndim=2, eqn=Eqn.EULER, solver="hll", coords=Coord.CYLINDRICAL,
        shape=(n // 2, n), xmin=(0.0, -rmax / 2), xmax=(rmax / 2, rmax / 2),
        bcs=(("axisymmetric", "outflow"), ("outflow", "outflow")),
        cfl=0.3, tmax=1.0,
    )
    P0 = np.zeros((cfg.nvar,) + cfg.shape)
    P0[RO] = 100.0 * M_P
    P0[PG] = 100.0 * 1.380649e-16 * 100.0
    src = WindSource(position=(0.0, 0.0), radius=10.0 * rmax / n,
                     mdot=1.0e-6 * MSUN_YR, vinf=2.0e8, t_wind=2.0e4,
                     rstar=7.0e11, model="angle", v_rot=3.0e7, vcrit=6.0e7)
    phys = Physics(wind_sources=[src])
    sim = Simulation(cfg, jnp.asarray(P0), physics=phys)
    P = np.asarray(sim.P)
    assert np.all(np.isfinite(P))
    w = sim.physics.winds[0]
    mask = np.asarray(w.mask) & ~np.asarray(w.inner)
    d = np.asarray(w.dist)
    th = np.asarray(w.theta)
    sel = mask & (d > 0.8 * src.radius)
    # at fixed d-bin, density at high theta (equator) above low theta (pole)
    rho = P[iRO]
    eq = sel & (th > 1.2)
    pol = sel & (th < 0.5)
    assert rho[eq].mean() > rho[pol].mean()


def test_orbiting_source_moves_and_returns():
    rmax = 0.5 * PC
    n = 64
    cfg = SimConfig(
        ndim=2, eqn=Eqn.EULER, solver="hll", coords=Coord.CARTESIAN,
        shape=(n, n), xmin=(-rmax, -rmax), xmax=(rmax, rmax),
        bcs=(("outflow", "outflow"), ("outflow", "outflow")),
        cfl=0.3, tmax=1.0,
    )
    period_yr = 100.0
    src = WindSource(position=(0.0, 0.0), radius=6.0 * 2 * rmax / n,
                     mdot=1.0e-6 * MSUN_YR, vinf=2.0e8,
                     orb_period=period_yr, eccentricity_fac=1.0,
                     periastron=(0.1 * rmax, 0.0))
    P0 = np.zeros((cfg.nvar,) + cfg.shape)
    P0[RO] = 100.0 * M_P
    P0[PG] = 1.0e-10
    phys = Physics(wind_sources=[src])
    sim = Simulation(cfg, jnp.asarray(P0), physics=phys)
    w = sim.physics.winds[0]
    from pion_tpu.constants import YEAR
    p0 = np.asarray([float(x) for x in w.position_at(0.0)])
    ph = np.asarray([float(x) for x in w.position_at(0.5 * period_yr * YEAR)])
    p1 = np.asarray([float(x) for x in w.position_at(period_yr * YEAR)])
    np.testing.assert_allclose(p0, [0.0, 0.0], atol=1e-6 * rmax)
    np.testing.assert_allclose(p1, p0, atol=1e-6 * rmax)
    assert np.linalg.norm(ph - p0) > 0.05 * rmax, "source did not move"
    # the overwrite region follows the source
    A0 = np.asarray(w.apply(jnp.asarray(P0), 0.0))
    Ah = np.asarray(w.apply(jnp.asarray(P0), 0.5 * period_yr * YEAR))
    assert not np.allclose(A0[RO], Ah[RO], atol=0.0)
    assert np.all(np.isfinite(A0)) and np.all(np.isfinite(Ah))


def test_mhd_wind_split_monopole():
    from pion_tpu.constants import BX as iBX, BY as iBY
    rmax = 0.5 * PC
    n = 64
    cfg = SimConfig(
        ndim=2, eqn=Eqn.GLM, solver="hll", coords=Coord.CYLINDRICAL,
        shape=(n // 2, n), xmin=(0.0, -rmax / 2), xmax=(rmax / 2, rmax / 2),
        bcs=(("axisymmetric", "outflow"), ("outflow", "outflow")),
        cfl=0.3, tmax=1.0,
    )
    P0 = np.zeros((cfg.nvar,) + cfg.shape)
    P0[RO] = 100.0 * M_P
    P0[PG] = 1.0e-10
    src = WindSource(position=(0.0, 0.0), radius=10.0 * rmax / n,
                     mdot=1.0e-6 * MSUN_YR, vinf=2.0e8, b_star=1.0,
                     rstar=7.0e11)
    phys = Physics(wind_sources=[src])
    sim = Simulation(cfg, jnp.asarray(P0), physics=phys)
    w = sim.physics.winds[0]
    W = np.asarray(w.wind_state(sim.P, 0.0))
    mask = np.asarray(w.mask)
    d = np.asarray(w.dist)
    # |B| ~ Bs/sqrt(4pi) (Rstar/d)^2 inside the region
    bmag = np.sqrt(W[iBX] ** 2 + W[iBY] ** 2)[mask]
    expect = (1.0 / np.sqrt(4 * np.pi)) * (src.rstar / d[mask]) ** 2
    np.testing.assert_allclose(bmag, expect, rtol=1e-10)


def test_wind_f32_safe():
    """cgs wind formulas must not overflow/underflow float32 (the reduced-
    precision mode): rho>0 and pg>0 throughout the region, dt finite, one step
    finite.  Regression for the 8*pi*r^2*v ~ 1e43 overflow."""
    import contextlib
    import jax

    @contextlib.contextmanager
    def no_x64():
        jax.config.update("jax_enable_x64", False)
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", True)

    with no_x64():
        rmax = np.float32(0.5 * PC)
        n = 32
        cfg = SimConfig(
            ndim=2, eqn=Eqn.EULER, solver="hll", coords=Coord.CYLINDRICAL,
            shape=(n // 2, n), xmin=(0.0, -rmax / 2), xmax=(rmax / 2, rmax / 2),
            bcs=(("axisymmetric", "outflow"), ("outflow", "outflow")),
            cfl=0.3, tmax=1.0, dtype="float32",
        )
        P0 = np.zeros((cfg.nvar,) + cfg.shape, np.float32)
        P0[RO] = 100.0 * M_P
        P0[PG] = 100.0 * 1.380649e-16 * 100.0
        for model, kw in (("iso", {}), ("angle", dict(v_rot=4.5e7, vcrit=5e7)),
                          ("latdep", dict(v_rot=4.5e7, vcrit=5e7))):
            src = WindSource(position=(0.0, 0.0), radius=10.0 * rmax / n,
                             mdot=1.0e-5 * MSUN_YR, vinf=2.0e8, t_wind=2.0e4,
                             rstar=7.0e11, model=model, **kw)
            sim = Simulation(cfg, jnp.asarray(P0), physics=Physics(
                wind_sources=[src]))
            P = np.asarray(sim.P)
            m = np.asarray(sim.physics.winds[0].mask)
            inner = np.asarray(sim.physics.winds[0].inner)
            free = m & ~inner
            assert P[RO][free].min() > 1e-30, f"{model}: rho underflow"
            assert P[PG][free].min() > 1e-30, f"{model}: pg underflow"
            sim.run(max_steps=3, tmax=1e30)
            assert np.isfinite(sim.t) and sim.t > 0, f"{model}: dt went NaN"
            assert np.all(np.isfinite(np.asarray(sim.P))), model
