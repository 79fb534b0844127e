"""Profile the flagship NG coupled step (the bench composition) piece by
piece: per-level dynamics, traces, chemistry, NG plumbing, dt."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from pion_tpu.device import use_compile_cache  # noqa: E402

use_compile_cache()

import jax.numpy as jnp
import numpy as np


def timed(label, fn, *args, k=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(k):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / k
    print(f"{label:44s} {dt*1e3:10.2f} ms", flush=True)
    return dt


def main():
    from pion_tpu import SimConfig
    from pion_tpu.constants import BX, K_B, MSUN, PG, RO, RSUN, YEAR
    from pion_tpu.microphysics import MPv3, MPv3Config
    from pion_tpu.ng import NGHierarchy
    from pion_tpu.physics import Physics
    from pion_tpu.raytracing import Source
    from pion_tpu.winds import WindSource

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 128
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
        P0[BX] = 4.0e-6 / np.sqrt(4.0 * np.pi)
        states.append(jnp.asarray(P0))
    hier.set_states(states)
    print(f"NG flagship {n}^3 x {nlev} levels", flush=True)

    # components on level 0
    P = hier.P[0]
    ph0 = hier.phys[0]
    mp = phys.mp

    @jax.jit
    def do_trace(Ph):
        return ph0.raytrace(Ph)

    rt = do_trace(P)
    jax.block_until_ready(rt)
    timed("raytrace (mfion, level 0)", do_trace, P, k=3)

    dt0 = hier.compute_dt()
    print(f"dt={dt0:.3e}", flush=True)

    @jax.jit
    def do_ydot(P):
        nHv = mp.n_H(P[RO])
        Eint = P[PG] / (mpc.gamma - 1.0)
        omx = jnp.clip(1.0 - P[mpc.tracer_slot], 1e-20, 1.0 - 1e-20)
        return mp.ydot(omx, Eint, nHv, rt)

    timed("ydot mfion (1 full-grid eval)", do_ydot, P, k=3)

    @jax.jit
    def do_update(P):
        return mp._update_impl(P, dt0, cfg, rt)

    timed("mp update (euler+ladder)", do_update, P, k=3)

    @jax.jit
    def do_dyn(P):
        from pion_tpu.ops.sweep import dynamics_dU

        Ppad = jnp.pad(P, ((0, 0),) + ((2, 2),) * 3, mode="edge")
        dU, _ = dynamics_dU(Ppad, cfg.with_(nlevels=1), hier.geoms[0], dt0,
                            2, ch=1.0, scma=True)
        return dU

    timed("dynamics dU (1 level, corrector)", do_dyn, P, k=3)

    # dt fn
    timed("NG compute_dt (all levels)", lambda: hier.compute_dt(), k=3)

    # full step: explicit-dt path (unfused) and the fused dt+step path
    timed("FULL NG step (explicit dt)", lambda: (hier.step(dt0),
                                                 hier.P[0])[1], k=3)
    timed("FULL NG step (fused dt+step)", lambda: (hier.step(),
                                                   hier.P[0])[1], k=3)


if __name__ == "__main__":
    main()
