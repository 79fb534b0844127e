"""Nested-grid tests: prolongation/restriction consistency, conservation
with BC89 flux correction, and NG-vs-uniform shock agreement
(the reference's NG_shocktube / NG advection gates, SURVEY.md §4)."""
import numpy as np
import jax.numpy as jnp

from pion_tpu import Eqn, SimConfig, Simulation
from pion_tpu.constants import PG, RO, VX
from pion_tpu.grid import make_geometry
from pion_tpu.ics import toro_tests
from pion_tpu.ics.blast import blast_wave
from pion_tpu.ng import NGHierarchy, make_level_cfg
from pion_tpu.ops.eqns import prim_to_cons


def init_levels(hier, fill):
    """Fill every level from an analytic function of position."""
    states = []
    for l in range(hier.n_levels):
        cfg = hier.cfgs[l]
        coords = [cfg.cell_centers(ax) for ax in range(cfg.ndim)]
        grids = np.meshgrid(*coords, indexing="ij")
        states.append(jnp.asarray(fill(cfg, grids)))
    hier.set_states(states)


def test_prolong_restrict_roundtrip():
    """A linear profile must prolong exactly (2nd-order interpolation) and
    restrict back to itself."""
    cfg0 = SimConfig(ndim=1, eqn=Eqn.EULER, shape=(32,), xmin=(0.0,),
                     xmax=(1.0,), bcs=(("outflow", "outflow"),))
    hier = NGHierarchy(cfg0, 2)

    def fill(cfg, grids):
        x = grids[0]
        P = np.zeros((cfg.nvar,) + cfg.shape)
        P[RO] = 1.0 + 0.5 * x
        P[PG] = 2.0 - 0.3 * x
        return P

    init_levels(hier, fill)
    padded = hier._prolong_padded(hier.P[0], 1)
    cfg1 = hier.cfgs[1]
    x_pad = cfg1.cell_centers(0, padded=True)
    np.testing.assert_allclose(np.asarray(padded[RO]), 1.0 + 0.5 * x_pad,
                               rtol=1e-12)
    # restriction of the fine level leaves the coarse linear profile intact
    Pc2 = hier._restrict(hier.P[0], hier.P[1], 1)
    np.testing.assert_allclose(np.asarray(Pc2[RO]), np.asarray(hier.P[0][RO]),
                               rtol=1e-12)


def test_ng_blast_conservation_2d():
    """2D blast fully inside the fine level: total mass/energy on the
    composite grid is conserved (BC89 keeps levels consistent)."""
    n = 32
    cfg0 = SimConfig(ndim=2, eqn=Eqn.EULER, solver="hll", shape=(n, n),
                     xmin=(0.0, 0.0), xmax=(1.0, 1.0),
                     bcs=(("outflow", "outflow"),) * 2, cfl=0.3, ooa=2,
                     av="falle", etav=0.1)
    hier = NGHierarchy(cfg0, 2)

    def fill(cfg, grids):
        return blast_wave(cfg, rho0=1.0, p0=0.1, p_in=10.0, r_in=0.08,
                          center=(0.5, 0.5))

    init_levels(hier, fill)

    def composite_mass_energy(h):
        # coarse cells covered by the fine level are excluded; fine adds them
        Uc = np.asarray(prim_to_cons(h.P[0], h.cfgs[0]))
        Uf = np.asarray(prim_to_cons(h.P[1], h.cfgs[1]))
        vc = np.prod([h.geoms[0].dx] * 2)
        vf = np.prod([h.geoms[1].dx] * 2)
        q = n // 4
        mask = np.ones((n, n), dtype=bool)
        mask[q : 3 * q, q : 3 * q] = False
        m = Uc[RO][mask].sum() * vc + Uf[RO].sum() * vf
        e = Uc[PG][mask].sum() * vc + Uf[PG].sum() * vf
        return m, e

    m0, e0 = composite_mass_energy(hier)
    for _ in range(12):
        hier.step()
    m1, e1 = composite_mass_energy(hier)
    assert np.all(np.isfinite(np.asarray(hier.P[0])))
    assert np.all(np.isfinite(np.asarray(hier.P[1])))
    np.testing.assert_allclose(m1, m0, rtol=1e-10)
    np.testing.assert_allclose(e1, e0, rtol=1e-10)


def test_ng_shocktube_vs_uniform():
    """1D NG shocktube: the fine region must match a uniform fine-resolution
    run where the shock is inside the fine level."""
    n = 64
    base = dict(eqn=Eqn.EULER, solver="hll", gamma=1.4, cfl=0.3, ooa=2,
                av="falle", etav=0.1)
    cfg0 = SimConfig(ndim=1, shape=(n,), xmin=(0.0,), xmax=(1.0,),
                     bcs=(("outflow", "outflow"),), **base)
    hier = NGHierarchy(cfg0, 2)

    def fill(cfg, grids):
        x = grids[0]
        P = np.zeros((cfg.nvar,) + cfg.shape)
        # Sod-like IC centered at 0.5 (inside the fine level [0.25,0.75])
        P[RO] = np.where(x < 0.5, 1.0, 0.125)
        P[PG] = np.where(x < 0.5, 1.0, 0.1)
        return P

    init_levels(hier, fill)
    t_end = 0.08  # shock stays inside the fine region
    hier.run(t_end)

    cfg_u = SimConfig(ndim=1, shape=(2 * n,), xmin=(0.0,), xmax=(1.0,),
                      bcs=(("outflow", "outflow"),), **base)
    Pu = np.zeros((cfg_u.nvar, 2 * n))
    xu = cfg_u.cell_centers(0)
    Pu[RO] = np.where(xu < 0.5, 1.0, 0.125)
    Pu[PG] = np.where(xu < 0.5, 1.0, 0.1)
    sim = Simulation(cfg_u.with_(tmax=t_end), jnp.asarray(Pu))
    sim.run()

    # compare the fine level against the matching slice of the uniform run
    fine = np.asarray(hier.P[1][RO])
    uni = np.asarray(sim.P[RO])[n // 2 : 3 * n // 2]
    l1 = np.mean(np.abs(fine - uni)) / np.mean(uni)
    assert l1 < 0.02, f"NG-vs-uniform L1 {l1}"


# ---------------------------------------------------------------------------
# Raytracing on nested grids (reference: sim_control_NG.cpp RT_all_sources_levels)
# ---------------------------------------------------------------------------

def test_ng_infinity_source_tau_handdown():
    """A source at infinity shining along +x: the child level's entry-column
    offset must equal the coarse column from the global edge to the child
    boundary, so the composed fine tau matches the global cumsum."""
    from pion_tpu.constants import Coord, K_B, M_P
    from pion_tpu.microphysics.mpv7 import MPv7, MPv7Config
    from pion_tpu.physics import Physics
    from pion_tpu.raytracing import Source

    n = 32
    L = 3.0856775807e18
    cfg = SimConfig(ndim=2, eqn=Eqn.EULER, ntracer=1, coords=Coord.CARTESIAN,
                    solver="hll", shape=(n, n), xmin=(0.0, 0.0), xmax=(L, L),
                    bcs=(("outflow", "outflow"), ("outflow", "outflow")),
                    cfl=0.3, tmax=1.0)
    mpc = MPv7Config(tracer_slot=5, ion_src="mono", n_idot=1e48)
    mp = MPv7(mpc)
    src = Source(at_infinity=True, axis=1, sign=1, strength=1.0e10,
                 effect="mono")
    phys = Physics(mp=mp, sources=[src], dt_limit=False)
    hier = NGHierarchy(cfg, 2, physics=phys)

    nH = 100.0
    states = []
    for l in range(2):
        P = np.zeros((cfg.nvar,) + cfg.shape)
        P[RO] = nH * M_P
        P[PG] = nH * K_B * 100.0
        P[5] = 1e-12  # neutral
        states.append(jnp.asarray(P))
    hier.set_states(states)

    # offsets for the child from the root level
    offs = hier._child_tau_offsets(0, hier.P[0], None)
    assert offs is not None and 0 in offs
    # composed fine tau vs global analytic column (uniform medium):
    # tau(x) = rho/mh_per_H * sigma0 * (1-x_ion) * x  with x from global edge
    taus_f = hier.phys[1].trace_taus(hier.P[1], offs)
    tau_f = np.asarray(taus_f[0])
    from pion_tpu.microphysics.mpv3 import SIGMA0
    xpos = hier.cfgs[1].cell_centers(1)   # fine-level x coordinates
    kappa = nH * M_P * (1.0 - 1e-12) / mpc.mean_mass_per_h * SIGMA0 / M_P * M_P
    # entry tau of fine cell = kappa * (x - dx_f/2) measured from x=0 globally
    dx_f = hier.geoms[1].dx
    expect = kappa * (xpos - 0.5 * dx_f)
    np.testing.assert_allclose(tau_f[0, :], expect, rtol=1e-6)
    # and every row identical (plane wave)
    np.testing.assert_allclose(tau_f, np.broadcast_to(tau_f[0], tau_f.shape),
                               rtol=1e-12)


def test_ng_hii_region_point_source():
    """R-type HII region on a 2-level stack: the ionization front must be
    (a) finite and roughly circular on both levels, (b) consistent between
    the fine level and the restricted coarse overlap, (c) close to the
    uniform-grid result at the same (coarse) resolution."""
    from pion_tpu.constants import Coord, K_B, M_P
    from pion_tpu.microphysics.mpv7 import MPv7, MPv7Config
    from pion_tpu.physics import Physics
    from pion_tpu.raytracing import Source

    nH = 1000.0
    ndot = 3.0e48
    alpha = 2.7e-13
    r_s = (3.0 * ndot / (4.0 * np.pi * alpha * nH * nH)) ** (1.0 / 3.0)
    n = 64
    rmax = 2.4 * r_s
    cfg = SimConfig(ndim=2, eqn=Eqn.EULER, ntracer=1, coords=Coord.CARTESIAN,
                    solver="hll", shape=(n, n), xmin=(-rmax, -rmax),
                    xmax=(rmax, rmax),
                    bcs=(("outflow", "outflow"), ("outflow", "outflow")),
                    cfl=0.3, ooa=2, av="falle", etav=0.1, tmax=1.0)
    mpc = MPv7Config(tracer_slot=5, ion_src="mono", n_idot=ndot,
                     recomb_rate=alpha, t_lo=100.0, t_hi=1.0e4)

    def build_states(cfgs):
        out = []
        for c in cfgs:
            P = np.zeros((c.nvar,) + c.shape)
            P[RO] = nH * M_P / mpc.x_frac
            P[PG] = nH * K_B * 100.0
            P[5] = 1e-12
            out.append(jnp.asarray(P))
        return out

    def physics():
        return Physics(mp=MPv7(mpc),
                       sources=[Source(position=(0.0, 0.0), strength=ndot,
                                       effect="mono")],
                       dt_limit=False)

    # recombination time and a fraction of it (R-type phase)
    t_rec = 1.0 / (alpha * nH)
    t_end = 0.35 * t_rec

    hier = NGHierarchy(cfg, 2, physics=physics())
    hier.set_states(build_states(hier.cfgs))
    hier.run(tmax=t_end, max_steps=400)
    for l in range(2):
        assert np.all(np.isfinite(np.asarray(hier.P[l]))), f"level {l} NaN"

    sim = Simulation(cfg, build_states([cfg])[0], physics=physics())
    sim.run(tmax=t_end, max_steps=400)

    # front radius along +x from the fine level vs UG
    def front_radius(P, c):
        x = np.asarray(P[5])
        mid = c.shape[0] // 2
        row = x[mid, c.shape[1] // 2:]
        r = c.cell_centers(1)[c.shape[1] // 2:] if c.xmin[1] < 0 else None
        xs = c.cell_centers(1)
        xs = xs[xs > 0] if c.xmin[1] < 0 else xs
        idx = np.argmax(row < 0.5)
        return xs[idx]

    rf_fine = front_radius(hier.P[1], hier.cfgs[1])
    rf_ug = front_radius(sim.P, cfg)
    assert abs(rf_fine - rf_ug) / rf_ug < 0.25, (rf_fine, rf_ug)
    # the coarse overlap (restricted from fine) agrees with the fine front
    rf_coarse = front_radius(hier.P[0], hier.cfgs[0])
    assert abs(rf_coarse - rf_fine) / rf_fine < 0.25, (rf_coarse, rf_fine)


def test_ng_offcentre_levels_reference_layout():
    """NG_centre at a domain corner (Wind2D layout: centre on the R=0
    axis): level extents follow setup_NG_grid.cpp:142-155 and fine levels
    keep the domain BC on the coincident faces."""
    cfg0 = SimConfig(ndim=2, eqn=Eqn.EULER, solver="hll", shape=(16, 32),
                     xmin=(0.0, -4.0), xmax=(4.0, 4.0),
                     bcs=(("reflecting", "outflow"), ("outflow", "outflow")),
                     nlevels=3, ng_centre=(0.0, 2.0))
    hier = NGHierarchy(cfg0)
    # level 1: Rmin stays 0 (centre on boundary), x halves about 2.0
    np.testing.assert_allclose(hier.cfgs[1].xmin, (0.0, -1.0))
    np.testing.assert_allclose(hier.cfgs[1].xmax, (2.0, 3.0))
    np.testing.assert_allclose(hier.cfgs[2].xmin, (0.0, 0.5))
    np.testing.assert_allclose(hier.cfgs[2].xmax, (1.0, 2.5))
    # child windows: R-axis offset 0 (coincident), x-axis offset 12 cells
    assert hier.offs[1] == (0, 12)
    assert (0, 0) in hier.dom_sides[1] and (0, 0) in hier.dom_sides[2]

    def fill(cfg, grids):
        return blast_wave(cfg, rho0=1.0, p0=0.1, p_in=10.0, r_in=0.3,
                          center=(0.4, 2.0))

    init_levels(hier, fill)
    for _ in range(6):
        hier.step()
    for l in range(3):
        assert np.all(np.isfinite(np.asarray(hier.P[l]))), f"level {l}"


def test_ng_cylindrical_blast_conservation():
    """2-level CYLINDRICAL blast: volume-weighted restriction +
    area-weighted BC89 conserve composite mass/energy to roundoff
    (reference: NG_fine_to_coarse_boundaries.cpp:255-320,
    VectorOps.cpp:688-697)."""
    from pion_tpu.constants import Coord

    n = 32
    cfg0 = SimConfig(ndim=2, eqn=Eqn.EULER, solver="hll",
                     coords=Coord.CYLINDRICAL, shape=(n, n),
                     xmin=(0.0, -1.0), xmax=(2.0, 1.0),
                     bcs=(("reflecting", "reflecting"),
                          ("reflecting", "reflecting")),
                     cfl=0.3, ooa=2, av="falle", etav=0.1,
                     nlevels=2, ng_centre=(0.0, 0.0))
    hier = NGHierarchy(cfg0)
    assert hier.offs[1] == (0, 8)

    def fill(cfg, grids):
        R, z = grids
        r = np.sqrt(R**2 + z**2)
        P = np.zeros((cfg.nvar,) + cfg.shape)
        P[RO] = 1.0
        P[PG] = np.where(r < 0.25, 10.0, 0.1)
        return P

    init_levels(hier, fill)

    def composite(h):
        Uc = np.asarray(prim_to_cons(h.P[0], h.cfgs[0]))
        Uf = np.asarray(prim_to_cons(h.P[1], h.cfgs[1]))
        vc = np.broadcast_to(h.geoms[0].cell_volume, Uc.shape[1:])
        vf = np.broadcast_to(h.geoms[1].cell_volume, Uf.shape[1:])
        off = h.offs[1]
        mask = np.ones(Uc.shape[1:], dtype=bool)
        mask[off[0]:off[0] + n // 2, off[1]:off[1] + n // 2] = False
        m = (Uc[RO] * vc)[mask].sum() + (Uf[RO] * vf).sum()
        e = (Uc[PG] * vc)[mask].sum() + (Uf[PG] * vf).sum()
        return m, e

    m0, e0 = composite(hier)
    for _ in range(10):
        hier.step()
    m1, e1 = composite(hier)
    assert np.all(np.isfinite(np.asarray(hier.P[0])))
    assert np.all(np.isfinite(np.asarray(hier.P[1])))
    np.testing.assert_allclose(m1, m0, rtol=1e-11)
    np.testing.assert_allclose(e1, e0, rtol=1e-11)


def test_ng_snapshot_restart_bitwise(tmp_path):
    """NG save -> restart -> identical continuation (reference: every
    snapshot is a full multi-level restart file, dataio_silo.h:67)."""
    cfg0 = SimConfig(ndim=2, eqn=Eqn.EULER, solver="hll", shape=(16, 16),
                     xmin=(0.0, 0.0), xmax=(1.0, 1.0),
                     bcs=(("outflow", "outflow"),) * 2, cfl=0.3,
                     nlevels=2)
    hier = NGHierarchy(cfg0)

    def fill(cfg, grids):
        return blast_wave(cfg, rho0=1.0, p0=0.1, p_in=10.0, r_in=0.1,
                          center=(0.5, 0.5))

    init_levels(hier, fill)
    for _ in range(3):
        hier.step()
    path = hier.save(str(tmp_path / "ng_ckpt"))
    # continue original
    for _ in range(3):
        hier.step()

    h2 = NGHierarchy.restart(path)
    assert h2.n_levels == 2 and h2.step_count == 3
    for _ in range(3):
        h2.step()
    for l in range(2):
        np.testing.assert_array_equal(np.asarray(hier.P[l]),
                                      np.asarray(h2.P[l]))


def test_ng_chunked_run_matches_stepwise():
    """chunk>1 hierarchy stepping (one lax.scan dispatch per K steps)
    must reproduce the per-step path bitwise: same dt policy, same
    states, same end time."""
    import jax.numpy as jnp

    from pion_tpu import SimConfig
    from pion_tpu.ics import blast_wave
    from pion_tpu.ng import NGHierarchy

    cfg = SimConfig(ndim=2, eqn="glm", solver="hlld", shape=(32, 32),
                    xmin=(0.0, 0.0), xmax=(1.0, 1.0),
                    bcs=(("outflow", "outflow"),) * 2, cfl=0.3, ooa=2,
                    av="falle", etav=0.1, nlevels=2, tmax=1.0,
                    dtype="float64")
    states = None
    sims = []
    for chunk in (1, 4):
        hier = NGHierarchy(cfg, 2)
        if states is None:
            states = [jnp.asarray(blast_wave(c, B0=(0.05, 0.02, 0.0))
                                  .astype(cfg.np_dtype))
                      for c in hier.cfgs]
        hier.set_states(states)
        hier.run(max_steps=8, chunk=chunk)
        sims.append(hier)
    a, b = sims
    assert a.step_count == b.step_count == 8
    assert abs(a.t - b.t) <= 1e-12 * a.t
    for l in range(2):
        np.testing.assert_array_equal(np.asarray(a.P[l]),
                                      np.asarray(b.P[l]))
