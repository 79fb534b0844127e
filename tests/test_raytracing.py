"""Raytracing tests: column densities vs geometry, and a Stromgren-sphere
gate (the reference's test_RT_nodyn / Iliev-test analogues, SURVEY.md §4)."""
import numpy as np
import jax.numpy as jnp
import pytest

from pion_tpu import Coord, Eqn, SimConfig, make_geometry
from pion_tpu.constants import K_B, PG, RO, YEAR
from pion_tpu.microphysics.mpv7 import MPv7, MPv7Config
from pion_tpu.raytracing import PointSourceTracer, parallel_rays


def test_parallel_rays_cumsum():
    dtau = jnp.asarray(np.full((4, 8), 0.25))
    tau, ds, vshell = parallel_rays(dtau, axis=1, sign=1, dx=0.1)
    np.testing.assert_allclose(np.asarray(tau[0]), 0.25 * np.arange(8))
    tau_r, _, _ = parallel_rays(dtau, axis=1, sign=-1, dx=0.1)
    np.testing.assert_allclose(np.asarray(tau_r[0]), 0.25 * np.arange(7, -1, -1))


def cfg2d(n=32):
    return SimConfig(ndim=2, eqn=Eqn.EULER, shape=(n, n),
                     xmin=(0.0, 0.0), xmax=(1.0, 1.0),
                     bcs=(("outflow", "outflow"),) * 2)


def test_point_source_2d_uniform_medium():
    """tau to cell entry in a uniform medium ~ chi*(r-ds/2)."""
    n = 33
    cfg = cfg2d(n)
    geom = make_geometry(cfg)
    tr = PointSourceTracer(cfg, geom, (0.5, 0.5))
    chi = 10.0  # opacity per unit length
    dtau = jnp.asarray(chi * tr.ds)
    tau = np.asarray(tr.trace(dtau))
    # exact ray answer at the cell entry point
    si, sj = tr.src_idx
    x = cfg.cell_centers(1)
    y = cfg.cell_centers(0)
    Y, X = np.meshgrid(y, x, indexing="ij")
    r = np.hypot(X - 0.5, Y - 0.5)
    expected = chi * np.maximum(r - 0.5 * tr.ds, 0.0)
    # source cell exact zero
    assert tau[si, sj] == 0.0
    # on-axis and diagonal rays: compare where r > a few cells
    mask = r > 4.0 / n
    rel = np.abs(tau[mask] - expected[mask]) / np.maximum(expected[mask], 1e-10)
    assert np.median(rel) < 0.12, f"median rel err {np.median(rel)}"
    assert rel.max() < 0.5


def test_point_source_3d_runs():
    n = 17
    cfg = SimConfig(ndim=3, eqn=Eqn.EULER, shape=(n, n, n),
                    xmin=(0.0,) * 3, xmax=(1.0,) * 3,
                    bcs=(("outflow", "outflow"),) * 3)
    geom = make_geometry(cfg)
    tr = PointSourceTracer(cfg, geom, (0.5, 0.5, 0.5))
    dtau = jnp.asarray(5.0 * tr.ds)
    tau = np.asarray(tr.trace(dtau))
    assert np.all(np.isfinite(tau))
    assert tau[tr.src_idx] == 0.0
    # monotone along the +x axis through the source (the first ring has
    # tau=0 by the near-source cutoff, matching cell_cols_2d:2181-2218)
    si, sj, sk = tr.src_idx
    line = tau[si, sj, sk:]
    assert np.all(np.diff(line)[1:] > 0)
    assert line[1] == 0.0


def test_stromgren_sphere_1d():
    """Static Stromgren sphere with MPv7 (fixed alpha): the ionization front
    must approach R_S = (3 Ndot / 4 pi alpha nH^2)^(1/3)
    (the reference's Iliev+06 test-1 analogue via MPv6/MPv7)."""
    n = 64
    nH = 100.0            # cm^-3
    ndot = 1.0e48         # photons/s
    alpha = 2.7e-13
    r_s = (3.0 * ndot / (4.0 * np.pi * alpha * nH * nH)) ** (1.0 / 3.0)
    rmax = 2.0 * r_s
    cfg = SimConfig(ndim=1, eqn=Eqn.EULER, ntracer=1, coords=Coord.SPHERICAL,
                    shape=(n,), xmin=(0.0,), xmax=(rmax,),
                    bcs=(("reflecting", "outflow"),))
    geom = make_geometry(cfg)
    mp = MPv7(MPv7Config(tracer_slot=5, ion_src="mono", n_idot=ndot,
                         recomb_rate=alpha))
    tr = PointSourceTracer(cfg, geom, (0.0,))

    P = np.zeros((cfg.nvar, n))
    P[RO] = nH * 1.67262192369e-24 / (1.0 - 0.2703)  # rho = nH * m_p / X
    P[PG] = nH * K_B * 100.0
    P[5] = 1e-10
    P = jnp.asarray(P)

    sigma0 = 6.3042e-18
    ds = jnp.asarray(tr.ds)
    vshell = jnp.asarray(tr.vshell)
    t_rec = 1.0 / (alpha * nH)
    dt = 0.05 * t_rec
    mpc = mp.mpc
    for _ in range(100):  # 5 recombination times -> near equilibrium
        nH_arr = mp.n_H(P[RO])
        omx = jnp.clip(1.0 - P[5], 1e-20, 1.0)
        dtau = nH_arr * omx * sigma0 * ds
        tau = tr.trace(dtau)
        rt = {"tau0": tau, "ds": ds, "vshell": vshell, "n_idot": ndot}
        P = mp.update(P, dt, cfg, rt=rt)
    x = np.asarray(P[5])
    r = cfg.cell_centers(0)
    # ionization front radius: where x drops through 0.5
    idx = np.argmax(x < 0.5)
    r_front = r[idx]
    assert abs(r_front - r_s) / r_s < 0.15, (
        f"front at {r_front:.3e}, Stromgren {r_s:.3e}")


# (shape, source position as a fraction of the extent): centred, off-centre,
# corner and boundary sources in 3D and 2D (the corner/off-centre cases
# exercise the clamped plane indices)
PLANE_CASES = [
    ((32, 32), (0.503, 0.493)),
    ((33, 33), (0.1, 0.867)),
    ((16, 16, 16), (0.5, 0.5, 0.5)),
    ((20, 20, 20), (0.067, 0.933, 0.367)),
    ((16, 12, 20), (0.3, 0.6, 0.45)),
    ((8, 8, 8), (0.03, 0.03, 0.03)),
    ((8, 8, 8), (0.97, 0.2, 0.6)),
    ((16, 16), (0.5, 0.5)),
    ((12, 20), (0.3, 0.7)),
    ((16, 16), (0.02, 0.9)),
]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape,pos_frac", PLANE_CASES)
def test_plane_sweep_matches_shell_scan(shape, pos_frac, dtype):
    """The Chebyshev-shell plane sweep (production 2D/3D tracer) computes
    the same columns as the L1-shell gather/scatter scan: same per-cell
    formula, same upstream cells, different (but equally valid)
    topological order.  f32 allows reassociation of the weighted sums."""
    from pion_tpu.raytracing.tracer import (PointSourcePlaneTracer,
                                            PointSourceTracer)

    nd = len(shape)
    xmax = tuple(n / 16 for n in shape)
    cfg = SimConfig(ndim=nd, eqn="euler", solver="hll", shape=shape,
                    xmin=(0.0,) * nd, xmax=xmax,
                    bcs=(("outflow", "outflow"),) * nd, tmax=1.0,
                    dtype=dtype)
    geom = make_geometry(cfg)
    pos = tuple(f * x for f, x in zip(pos_frac, xmax))
    rng = np.random.default_rng(3)
    dtau = jnp.asarray(rng.uniform(0.01, 0.5, shape).astype(dtype))
    t_shell = PointSourceTracer(cfg, geom, pos)
    t_plane = PointSourcePlaneTracer(cfg, geom, pos)
    a = np.asarray(t_shell.trace(dtau))
    b = np.asarray(t_plane.trace(dtau))
    assert b.dtype == np.dtype(dtype)
    if dtype == "float64":
        np.testing.assert_allclose(b, a, rtol=1e-13, atol=0.0)
    else:
        assert np.max(np.abs(b - a)) < 5e-6 * np.max(a)
    np.testing.assert_allclose(t_plane.ds, t_shell.ds)
    np.testing.assert_allclose(t_plane.vshell, t_shell.vshell)
