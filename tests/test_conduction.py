"""Saturated thermal conduction (Slavin & Cox 1992) tests.

Gates: Spitzer classical limit for shallow gradients, saturation bound for
steep ones, zero net energy change with no-flux edges, and a stable
end-to-end run (reference: solver_eqn_base.cpp:687-875, compile-flagged
THERMAL_CONDUCTION)."""
import numpy as np
import jax.numpy as jnp

from pion_tpu import Coord, Eqn, SimConfig, Simulation
from pion_tpu.boundaries import apply_bcs, make_fixed_strips
from pion_tpu.constants import K_B, M_P, PG, RO
from pion_tpu.grid import make_geometry
from pion_tpu.ops.conduction import conduction_Edot


def setup_1d(n=128, L=3.0e18, T0=1.0e6, dT=1.0e3, nH=1.0):
    cfg = SimConfig(ndim=1, eqn=Eqn.EULER, solver="hll", shape=(n,),
                    xmin=(0.0,), xmax=(L,),
                    bcs=(("outflow", "outflow"),), conduction=True)
    geom = make_geometry(cfg)
    x = cfg.cell_centers(0)
    T = T0 + dT * np.sin(2 * np.pi * x / L)
    P = np.zeros((cfg.nvar, n))
    P[RO] = nH * M_P
    P[PG] = nH * K_B * T  # mu = 1 convention (reference: p = rho k T / m_p)
    return cfg, geom, jnp.asarray(P), T, x


def test_spitzer_classical_limit():
    """Shallow gradient: Edot -> d/dx(kappa dT/dx), kappa = 1.84e-5 T^2.5/lnL
    with lnL = 29.7 + ln(T/1e6/sqrt(rho*4.2735e23)) for T>4.2e5."""
    cfg, geom, P, T, x = setup_1d()
    Ppad = apply_bcs(P, cfg, make_fixed_strips(np.asarray(P), cfg))
    Tpad = Ppad[PG] / Ppad[RO] * (M_P / K_B)
    Edot = np.asarray(conduction_Edot(Ppad, Tpad, cfg, geom))
    # analytic: faces at x +- dx/2
    dx = geom.dx
    xf = x[:-1] + 0.5 * dx
    L = cfg.xmax[0]
    Tf = 1.0e6 + 1.0e3 * np.sin(2 * np.pi * xf / L)
    gradT = (T[1:] - T[:-1]) / dx
    rho = M_P
    # donor cell temperature: larger-T side
    up = gradT > 0
    Td = np.where(up, T[1:], T[:-1])
    lnL = 29.7 + np.log(Td / (1.0e6 * np.sqrt(rho * 4.2735e23)))
    q = -1.84e-5 * Td**2.5 * gradT / lnL
    expect = np.zeros_like(T)
    expect[1:-1] = (q[:-1] - q[1:]) / dx
    # interior cells (away from zero-flux edges)
    np.testing.assert_allclose(Edot[2:-2], expect[2:-2], rtol=2e-2)
    # no-flux edges: total energy change ~ 0
    assert abs(Edot.sum()) < 1e-6 * np.abs(Edot).max()


def test_saturation_bound():
    """A near-discontinuous T jump: |divQ| must be bounded by the saturated
    flux 1.5 p^1.5/sqrt(rho) divided by dx."""
    n = 64
    cfg = SimConfig(ndim=1, eqn=Eqn.EULER, solver="hll", shape=(n,),
                    xmin=(0.0,), xmax=(3.0e18,),
                    bcs=(("outflow", "outflow"),), conduction=True)
    geom = make_geometry(cfg)
    P = np.zeros((cfg.nvar, n))
    T = np.where(np.arange(n) < n // 2, 1.0e4, 1.0e8)
    P[RO] = M_P
    P[PG] = K_B * T
    Pj = jnp.asarray(P)
    Ppad = apply_bcs(Pj, cfg, make_fixed_strips(P, cfg))
    Tpad = Ppad[PG] / Ppad[RO] * (M_P / K_B)
    Edot = np.asarray(conduction_Edot(Ppad, Tpad, cfg, geom))
    qsat_max = 1.5 * (K_B * 1.0e8) ** 1.5 / np.sqrt(M_P)
    assert np.abs(Edot).max() <= 2.0 * qsat_max / geom.dx
    assert np.all(np.isfinite(Edot))
    # heat flows from hot to cold: cold side of the jump gains energy
    assert Edot[n // 2 - 1] > 0 and Edot[n // 2] < 0


def test_conduction_run_smooths_temperature():
    """End-to-end: a hot spike in a uniform medium diffuses; energy is
    conserved; the run is stable with the conduction dt limit."""
    n = 64
    L = 3.0e17
    cfg = SimConfig(ndim=1, eqn=Eqn.EULER, solver="hll", shape=(n,),
                    xmin=(0.0,), xmax=(L,), cfl=0.3,
                    bcs=(("outflow", "outflow"),), conduction=True,
                    p_ref=1.0e-12, tmax=1.0e20)
    x = cfg.cell_centers(0)
    T = 1.0e6 * (1.0 + 2.0 * np.exp(-((x - 0.5 * L) / (0.1 * L)) ** 2))
    P = np.zeros((cfg.nvar, n))
    P[RO] = 0.01 * M_P
    P[PG] = 0.01 * K_B * T
    sim = Simulation(cfg, jnp.asarray(P))
    T0_max = T.max() / 1.0e6
    e0 = np.sum(np.asarray(sim.P[PG]))
    sim.run(tmax=1.0e11, max_steps=200)
    Pn = np.asarray(sim.P)
    assert np.all(np.isfinite(Pn))
    Tn = Pn[PG] * M_P / (Pn[RO] * K_B) / 1.0e6
    assert Tn.max() < 0.95 * T0_max, "spike did not diffuse"
    assert Tn.max() > 1.0, "background should stay ~1e6 K"


def test_conduction_2d_pallas_no_physics():
    """2D f32 conduction run with no microphysics: guards the stepper's
    physics-None handling (regression: scma flag crashed when physics was
    None)."""
    n = 16
    L = 3.0e17
    cfg = SimConfig(ndim=2, eqn=Eqn.EULER, solver="hll", shape=(n, n),
                    xmin=(0.0, 0.0), xmax=(L, L), cfl=0.3,
                    bcs=(("outflow", "outflow"),) * 2, conduction=True,
                    p_ref=1.0e-12, tmax=1.0e20, dtype="float32")
    x = cfg.cell_centers(0)
    T = 1.0e6 * (1.0 + 2.0 * np.exp(-((x - 0.5 * L) / (0.2 * L)) ** 2))
    P = np.zeros((cfg.nvar, n, n), dtype=np.float32)
    P[RO] = 0.01 * M_P
    P[PG] = 0.01 * K_B * T[:, None]
    sim = Simulation(cfg, jnp.asarray(P))
    sim.run(tmax=1.0e10, max_steps=5)
    assert np.all(np.isfinite(np.asarray(sim.P)))
