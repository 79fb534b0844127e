"""Multi-dimensional and curvilinear-coordinate tests.

Gates modeled on the reference suite (SURVEY.md §4): axis-equivalence
(serial-vs-parallel style exactness), uniform-state preservation on
curvilinear grids (geometric source / flux-divergence cancellation), and
2D MHD stability (Orszag-Tang, field loop).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from pion_tpu import Coord, Eqn, SimConfig, Simulation, Solver
from pion_tpu.constants import BX, BY, BZ, PG, RO, VX, VY
from pion_tpu.ics import orszag_tang, toro_tests
from pion_tpu.ics.blast import blast_wave


def test_axis_equivalence_2d():
    """A 1D shock tube swept along y must give bitwise the same answer as
    along x (catches sweep-frame rotation errors)."""
    n = 64
    base = dict(eqn=Eqn.EULER, solver=Solver.HLL, gamma=1.4, cfl=0.3,
                ooa=2, av="falle", etav=0.1, tmax=0.05)
    cfg1 = SimConfig(ndim=1, shape=(n,), xmin=(0.0,), xmax=(1.0,),
                     bcs=(("outflow", "outflow"),), **base)
    P1 = toro_tests(cfg1, 1)
    sim1 = Simulation(cfg1, jnp.asarray(P1))
    sim1.run()

    # 2D: vary along x (axis 1), uniform along y
    cfg2x = SimConfig(ndim=2, shape=(8, n), xmin=(0.0, 0.0), xmax=(0.125, 1.0),
                      bcs=(("periodic", "periodic"), ("outflow", "outflow")),
                      **base)
    P2 = np.repeat(P1[:, None, :], 8, axis=1)
    sim2x = Simulation(cfg2x, jnp.asarray(P2))
    sim2x.run()

    # 2D: vary along y (axis 0), uniform along x; velocity must be v_y
    cfg2y = SimConfig(ndim=2, shape=(n, 8), xmin=(0.0, 0.0), xmax=(1.0, 0.125),
                      bcs=(("outflow", "outflow"), ("periodic", "periodic")),
                      **base)
    P2y = np.repeat(P1[:, :, None], 8, axis=2)
    # swap vx <-> vy: the tube now runs along physical y
    P2y[[VX, VY]] = P2y[[VY, VX]]
    sim2y = Simulation(cfg2y, jnp.asarray(P2y))
    sim2y.run()

    a = np.asarray(sim1.P)
    bx_ = np.asarray(sim2x.P)[:, 0, :]
    by_ = np.asarray(sim2y.P)[:, :, 0]
    np.testing.assert_allclose(bx_[RO], a[RO], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(bx_[VX], a[VX], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(by_[RO], a[RO], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(by_[VY], a[VX], rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("coords,ndim,shape", [
    (Coord.CYLINDRICAL, 2, (16, 16)),
    (Coord.SPHERICAL, 1, (64,)),
])
def test_uniform_state_preserved_curvilinear(coords, ndim, shape):
    """Static uniform gas on cylindrical/spherical grids must stay static:
    the geometric pressure source must exactly cancel the metric flux
    divergence (reference: solver_eqn_hydro_adi.cpp:560-707)."""
    bcs = ((("reflecting", "outflow"), ("outflow", "outflow"))
           if ndim == 2 else (("reflecting", "outflow"),))
    cfg = SimConfig(
        ndim=ndim, eqn=Eqn.EULER, solver=Solver.HLL, coords=coords,
        shape=shape, xmin=(0.0,) * ndim, xmax=(1.0,) * ndim,
        bcs=bcs, cfl=0.3, ooa=2, av="falle", etav=0.1, tmax=0.1,
    )
    P0 = np.zeros((cfg.nvar,) + cfg.shape)
    P0[RO] = 1.7
    P0[PG] = 0.83
    sim = Simulation(cfg, jnp.asarray(P0))
    for _ in range(20):
        sim.last_dt = 0.0
        sim.t = 0.0
        sim.step()
    out = np.asarray(sim.P)
    np.testing.assert_allclose(out[RO], 1.7, rtol=1e-11)
    np.testing.assert_allclose(out[PG], 0.83, rtol=1e-11)
    assert np.abs(out[VX : VX + ndim]).max() < 1e-11


def test_spherical_blast_runs():
    """1D spherical blast wave: shock propagates outward, stays finite
    (reference: test_problems blastwave_sph1d)."""
    cfg = SimConfig(
        ndim=1, eqn=Eqn.EULER, solver=Solver.EXACT, coords=Coord.SPHERICAL,
        shape=(128,), xmin=(0.0,), xmax=(1.0,),
        bcs=(("reflecting", "outflow"),), cfl=0.3, ooa=2,
        av="falle", etav=0.1, tmax=0.05,
    )
    P0 = blast_wave(cfg, rho0=1.0, p0=0.1, p_in=100.0, r_in=0.1)
    sim = Simulation(cfg, jnp.asarray(P0))
    sim.run()
    out = np.asarray(sim.P)
    assert np.all(np.isfinite(out))
    # shock moved outward: peak density beyond the initial hot region
    x = cfg.cell_centers(0)
    assert x[np.argmax(out[RO])] > 0.12
    # velocity at origin ~ 0 by symmetry
    assert abs(out[VX][0]) < 0.5


def test_orszag_tang_stable():
    """OT vortex (GLM-MHD, periodic): runs to t=0.2 finite with bounded
    div(B) (reference: test_problems OrszagTang)."""
    n = 64
    cfg = SimConfig(
        ndim=2, eqn=Eqn.GLM, solver=Solver.HLLD, gamma=5.0 / 3.0,
        shape=(n, n), xmin=(0.0, 0.0), xmax=(1.0, 1.0),
        bcs=(("periodic", "periodic"), ("periodic", "periodic")),
        cfl=0.3, ooa=2, av="falle", etav=0.1, tmax=0.2, p_ref=0.13,
    )
    P0 = orszag_tang(cfg)
    sim = Simulation(cfg, jnp.asarray(P0))
    sim.run()
    out = np.asarray(sim.P)
    assert np.all(np.isfinite(out))
    assert out[RO].min() > 0.0
    # divB (central differences, periodic) stays small relative to |B|/dx
    dx = cfg.dx
    divb = (
        (np.roll(out[BX], -1, axis=1) - np.roll(out[BX], 1, axis=1)) / (2 * dx)
        + (np.roll(out[BY], -1, axis=0) - np.roll(out[BY], 1, axis=0)) / (2 * dx)
    )
    bmag = np.sqrt(out[BX] ** 2 + out[BY] ** 2).mean()
    assert np.abs(divb).mean() * dx / bmag < 0.1


def test_scma_tracer_corrector():
    """sCMA (Plewa & Muller 1999): with a microphysics module active,
    out-of-range tracers advect as min(tracer, 1) in the upwind flux
    (reference: microphysics_base.cpp:80-131, solver_eqn_base.cpp:320-334).
    Pure-dynamics (colour-tracer) runs are unaffected."""
    from pion_tpu import make_geometry
    from pion_tpu.boundaries import BoundaryData, apply_bcs
    from pion_tpu.ops.sweep import dynamics_dU

    cfg = SimConfig(ndim=2, eqn=Eqn.EULER, solver=Solver.HLL, ntracer=1,
                    shape=(8, 16), xmin=(0.0, 0.0), xmax=(0.5, 1.0),
                    bcs=(("outflow", "outflow"),) * 2, av="none")
    geom = make_geometry(cfg)
    rng = np.random.default_rng(3)
    P0 = np.ones((cfg.nvar,) + cfg.shape)
    P0[1] = 0.6
    P0[2:4] = 0.3 * rng.standard_normal((2,) + cfg.shape)
    P0[cfg.eqn.nbase] = 1.5   # out-of-range ion fraction
    Ppad = apply_bcs(jnp.asarray(P0), cfg, BoundaryData())
    dU_off, _ = dynamics_dU(Ppad, cfg, geom, 1e-3, 2)
    dU_on, _ = dynamics_dU(Ppad, cfg, geom, 1e-3, 2, scma=True)
    tr = cfg.eqn.nbase
    # physical slots identical, tracer dU differs (clamped advection)
    np.testing.assert_array_equal(np.asarray(dU_off[:tr]),
                                  np.asarray(dU_on[:tr]))
    assert np.abs(np.asarray(dU_off[tr]) - np.asarray(dU_on[tr])).max() > 0
    # with all tracers in range the corrector is a no-op
    P0[tr] = 0.7
    Ppad = apply_bcs(jnp.asarray(P0), cfg, BoundaryData())
    a, _ = dynamics_dU(Ppad, cfg, geom, 1e-3, 2)
    b, _ = dynamics_dU(Ppad, cfg, geom, 1e-3, 2, scma=True)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_roe_hcorr_2d_all_axes():
    """Roe-CV + H-correction in 2D: the eta interface array must follow
    the sweep's hybrid (axis-moved) layout on non-minor axes (regression:
    shape mismatch crashed any roe+hcorr multi-D run; only Roe solvers
    consume the eta, so hybrid/HLL runs never saw it)."""
    import jax.numpy as jnp

    from pion_tpu.boundaries import apply_bcs, make_fixed_strips
    from pion_tpu.ops.sweep import dynamics_dU

    rng = np.random.default_rng(0)
    for eqn, solver in (("euler", "roe"), ("mhd", "roe")):
        cfg = SimConfig(ndim=2, eqn=eqn, solver=solver, ntracer=1,
                        shape=(24, 24), xmin=(0.0, 0.0), xmax=(1.0, 1.0),
                        bcs=(("outflow", "outflow"),) * 2, cfl=0.3, ooa=2,
                        av="hcorr_falle", etav=0.15, tmax=1.0)
        from pion_tpu.grid import make_geometry as _mg

        geom = _mg(cfg)
        P = np.ones((cfg.nvar,) + cfg.shape)
        P[0] = 1 + rng.random(cfg.shape)
        P[1] = 1 + rng.random(cfg.shape)
        P[2:5] = 0.3 * rng.standard_normal((3,) + cfg.shape)
        if cfg.eqn.is_mhd:
            P[5:8] = 0.2 * rng.standard_normal((3,) + cfg.shape)
        Ppad = apply_bcs(jnp.asarray(P), cfg, make_fixed_strips(P, cfg))
        dU, _ = dynamics_dU(Ppad, cfg, geom, 1e-3, 2, ch=1.0)
        assert np.all(np.isfinite(np.asarray(dU))), (eqn, solver)


def test_chunked_run_matches_per_step():
    """run(chunk=K) — K fused steps per dispatch — must reproduce the
    per-step loop exactly (same dt policy, in-graph)."""
    import jax.numpy as jnp

    from pion_tpu.ics.blast import blast_wave
    from pion_tpu.sim import Simulation

    cfg = SimConfig(ndim=2, eqn="glm", solver="hlld", ntracer=1,
                    shape=(32, 32), xmin=(0.0, 0.0), xmax=(1.0, 1.0),
                    bcs=(("outflow", "outflow"),) * 2, cfl=0.3, ooa=2,
                    av="falle", etav=0.1, tmax=0.05)
    P0 = blast_wave(cfg, B0=(0.1, 0.05, 0.0))
    a = Simulation(cfg, jnp.asarray(P0))
    b = Simulation(cfg, jnp.asarray(P0))
    a.run(max_steps=12)
    b.run(max_steps=12, chunk=4)
    assert b.step_count == a.step_count == 12
    assert np.isclose(b.t, a.t, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(b.P), np.asarray(a.P),
                               rtol=1e-12, atol=1e-13)

    # and with tmax landing inside a chunk: both must stop at tmax exactly
    c = Simulation(cfg, jnp.asarray(P0))
    d = Simulation(cfg, jnp.asarray(P0))
    c.run(tmax=0.02)
    d.run(tmax=0.02, chunk=8)
    assert np.isclose(d.t, c.t, rtol=1e-12)
    assert d.step_count == c.step_count
    np.testing.assert_allclose(np.asarray(d.P), np.asarray(c.P),
                               rtol=1e-12, atol=1e-13)


def test_scma_element_renormalization():
    """Declared element mass-fraction tracers advect with edge states
    renormalized to sum to 1 (reference: microphysics_base.cpp:96-118
    sCMA element loop)."""
    import jax.numpy as jnp

    from pion_tpu import SimConfig
    from pion_tpu.boundaries import BoundaryData, apply_bcs
    from pion_tpu.grid import make_geometry
    from pion_tpu.ops.sweep import dynamics_dU

    cfg = SimConfig(ndim=2, eqn="euler", solver="hll", ntracer=2,
                    shape=(16, 32), xmin=(0.0, 0.0), xmax=(0.5, 1.0),
                    bcs=(("outflow", "outflow"),) * 2,
                    cfl=0.3, ooa=2, av="falle", etav=0.1, dtype="float64")
    geom = make_geometry(cfg)
    rng = np.random.default_rng(9)
    P = np.ones((cfg.nvar,) + cfg.shape)
    P[2] = 0.5  # vx
    base = cfg.eqn.nbase
    # two "element" tracers that should sum to 1 but drift off
    P[base] = 0.6 + 0.1 * rng.random(cfg.shape)
    P[base + 1] = 0.5 + 0.1 * rng.random(cfg.shape)
    Pj = jnp.asarray(P)
    Ppad = apply_bcs(Pj, cfg, BoundaryData())
    el = (base, base + 1)
    _dU, faces = dynamics_dU(Ppad, cfg, geom, jnp.float64(1e-3), 2,
                             scma=el)
    # the advected element tracer fluxes are renormalized: flux ratio of
    # the two tracers equals the ratio of their (clamped, renormalized)
    # upwind values, and their summed flux equals the mass flux where
    # fm != 0
    F = faces[1]
    fm = np.asarray(F[0])
    ftr = np.asarray(F[base]) + np.asarray(F[base + 1])
    nz = np.abs(fm) > 1e-12
    np.testing.assert_allclose(ftr[nz], fm[nz], rtol=1e-12)
