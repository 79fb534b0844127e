"""Benchmark: 3D GLM-MHD grid-cell updates per second on one GPU.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline", ...}
with the device it ran on.  Exits with an error when JAX finds no GPU.

Baseline: the reference publishes no throughput numbers (BASELINE.md); we
normalize against 1.0e6 cell-updates/s/core, a standard figure for explicit
second-order finite-volume MHD in optimized C++ on one x86 core (the
reference's Ostar2D walltime — 256^2 x ~1e4 steps in 15 min on 32 cores —
implies ~0.7-2e6 including raytracing+chemistry, consistent with this).
``vs_baseline`` is therefore the speedup of one GPU over one CPU core of
the reference.
"""
import json
import time

import jax
import jax.numpy as jnp

from pion_tpu.device import require_gpu, use_compile_cache


def main():
    from pion_tpu import SimConfig
    from pion_tpu.boundaries import BoundaryData
    from pion_tpu.grid import make_geometry
    from pion_tpu.ics import blast_wave
    from pion_tpu.stepper import advance

    require_gpu()
    shape = (128, 128, 128)
    cfg = SimConfig(
        ndim=3, eqn="glm", solver="hlld", ntracer=1,
        shape=shape, xmin=(0.0, 0.0, 0.0), xmax=(1.0, 1.0, 1.0),
        bcs=tuple([("outflow", "outflow")] * 3),
        cfl=0.3, ooa=2, av="falle", etav=0.1, dtype="float32",
    )
    geom = make_geometry(cfg)
    bdata = BoundaryData()

    @jax.jit
    def step(P, dt):
        return advance(P, dt, cfg, geom, bdata)

    P = jnp.asarray(blast_wave(cfg, B0=(0.1, 0.05, 0.0)).astype(cfg.np_dtype))
    dt = jnp.asarray(1.0e-4, dtype=cfg.np_dtype)

    # warmup/compile
    jax.block_until_ready(step(step(P, dt), dt))

    n_iter = 20
    t0 = time.perf_counter()
    out = P
    for _ in range(n_iter):
        out = step(out, dt)
    jax.block_until_ready(out)
    elapsed = time.perf_counter() - t0

    ncell = 1
    for s in shape:
        ncell *= s
    ups = ncell * n_iter / elapsed

    coupled = coupled_bench()

    out = {
        "metric": "3D GLM-MHD (HLLD, OA2) cell updates/s/GPU",
        "value": round(ups),
        "unit": "cell-updates/s",
        "vs_baseline": round(ups / 1.0e6, 2),
    }
    out.update(coupled)
    dev = jax.devices()[0]
    out["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                     "count": len(jax.devices())}
    print(json.dumps(out))


def coupled_bench():
    """Flagship Ostar3D-class coupled step: 3D GLM-MHD (HLLD) on a 2-level
    nested grid + MPv3 multifrequency photoionization from a point source +
    a magnetized stellar wind — the full production composition
    (reference: test_problems/Ostar3D/run.sh:10-23 scale, RCW120 physics).
    Cell updates are counted over all levels (level l advances 2^l times
    per hierarchy step).  Reported as extra keys on the bench JSON line."""
    import numpy as np

    from pion_tpu import SimConfig
    from pion_tpu.constants import K_B, MSUN, PG, RO, RSUN, YEAR
    from pion_tpu.microphysics import MPv3, MPv3Config
    from pion_tpu.ng import NGHierarchy
    from pion_tpu.physics import Physics
    from pion_tpu.raytracing import Source
    from pion_tpu.winds import WindSource

    n = 128
    nlev = 2
    L = 6.0e18
    cfg = SimConfig(
        ndim=3, eqn="glm", solver="hlld", ntracer=1,
        shape=(n, n, n), xmin=(0.0,) * 3, xmax=(L,) * 3,
        bcs=tuple([("outflow", "outflow")] * 3), nlevels=nlev,
        cfl=0.3, ooa=2, av="falle", etav=0.1, dtype="float32",
        min_temperature=50.0, max_temperature=1.0e9, tmax=1.0e16,
    )
    mpc = MPv3Config(tracer_slot=cfg.eqn.nbase, ion_src="mfion",
                     n_idot=1.0e48, tstar=3.75e4, rstar_cm=10.0 * RSUN,
                     min_temperature=50.0)
    ctr = (0.5 * L,) * 3
    fine_dx = cfg.dx / 2 ** (nlev - 1)
    phys = Physics(
        mp=MPv3(mpc),
        sources=[Source(position=ctr, strength=1.0e48, effect="mfion")],
        wind_sources=[WindSource(position=ctr, radius=6.0 * fine_dx,
                                 mdot=1.0e-6 * MSUN / YEAR, vinf=2.0e8,
                                 t_wind=3.0e4, b_star=10.0,
                                 tracers=(1.0,))],
        dt_limit=True)

    nH = 100.0
    hier = NGHierarchy(cfg, nlev, physics=phys)
    states = []
    for l in range(nlev):
        P0 = np.zeros((cfg.nvar,) + cfg.shape, dtype=np.float32)
        P0[RO] = nH * mpc.mean_mass_per_h
        P0[PG] = 1.1 * nH * K_B * 300.0
        P0[cfg.eqn.nbase] = 1.0e-6
        B0 = 4.0e-6 / np.sqrt(4.0 * np.pi)   # ~Ostar3D UNIFORM_ambBX
        from pion_tpu.constants import BX
        P0[BX] = B0
        states.append(jnp.asarray(P0))
    hier.set_states(states)

    def run_steps(k):
        for _ in range(k):
            hier.step()
        jax.block_until_ready(hier.P)

    run_steps(2)                 # warm/compile
    k = 6
    # production stepping: k fused hierarchy steps per dispatch
    # (NGHierarchy.run(chunk=k) path; bitwise-identical to per-step runs)
    mfn = hier._multi_step_fn(k)
    st, _d = mfn(tuple(hier.P), hier.t, hier.last_dt, 1.0e16, None)
    jax.block_until_ready(st)
    t0 = time.perf_counter()
    st, _d = mfn(tuple(st), hier.t, hier.last_dt, 1.0e16, None)
    jax.block_until_ready(st)
    t_coupled = (time.perf_counter() - t0) / k

    # pure-dynamics NG step on the identical hierarchy for the cost ratio
    hier_dyn = NGHierarchy(cfg, nlev)
    hier_dyn.set_states(states)
    for _ in range(2):
        hier_dyn.step()
    jax.block_until_ready(hier_dyn.P)
    t0 = time.perf_counter()
    for _ in range(k):
        hier_dyn.step()
    jax.block_until_ready(hier_dyn.P)
    t_dyn = (time.perf_counter() - t0) / k

    updates = sum(2 ** l for l in range(nlev)) * n ** 3
    ups = updates / t_coupled
    return {
        "coupled_metric": ("3D GLM+HLLD 2-level NG + MPv3 mfion point "
                           "source + wind (Ostar3D-class) cell "
                           "updates/s/GPU"),
        "coupled_value": round(ups),
        "coupled_unit": "cell-updates/s",
        "coupled_over_dynamics": round(t_coupled / t_dyn, 2),
    }


if __name__ == "__main__":
    use_compile_cache()
    main()
