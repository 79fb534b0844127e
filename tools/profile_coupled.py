"""Profile the coupled MPv3+RT+wind step piece by piece on the GPU.

Times each component of the coupled path separately so optimization effort
goes where the wall-clock is: raytrace, ydot, stiff solve, mp update, full
advance.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from pion_tpu.device import use_compile_cache  # noqa: E402

use_compile_cache()

import jax.numpy as jnp
import numpy as np

from pion_tpu import SimConfig
from pion_tpu.constants import K_B, MSUN, PG, RO, YEAR
from pion_tpu.microphysics import MPv3, MPv3Config
from pion_tpu.physics import Physics
from pion_tpu.raytracing import Source
from pion_tpu.sim import Simulation
from pion_tpu.winds import WindSource


def timed(label, fn, *args, k=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(k):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / k
    print(f"{label:40s} {dt*1e3:10.2f} ms")
    return dt


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    L = 3.0e18
    cfg = SimConfig(
        ndim=3, eqn="euler", solver="hll", ntracer=1,
        shape=(n, n, n), xmin=(0.0,) * 3, xmax=(L,) * 3,
        bcs=tuple([("outflow", "outflow")] * 3),
        cfl=0.3, ooa=2, av="falle", etav=0.1, dtype="float32",
        min_temperature=50.0, max_temperature=1.0e9, tmax=1.0e16,
    )
    mpc = MPv3Config(tracer_slot=cfg.eqn.nbase, ion_src="mono",
                     n_idot=1.0e48)
    ctr = (0.5 * L,) * 3
    phys = Physics(
        mp=MPv3(mpc),
        sources=[Source(position=ctr, strength=1.0e48, effect="mono")],
        wind_sources=[WindSource(position=ctr, radius=6.0 * cfg.dx,
                                 mdot=1.0e-6 * MSUN / YEAR, vinf=2.0e8,
                                 t_wind=3.0e4, tracers=(1.0,))],
        dt_limit=False)

    nH = 300.0
    P0 = np.zeros((cfg.nvar,) + cfg.shape, dtype=np.float32)
    P0[RO] = nH * mpc.mean_mass_per_h
    P0[PG] = 1.1 * nH * K_B * 300.0
    P0[cfg.eqn.nbase] = 1.0e-6
    sim = Simulation(cfg, jnp.asarray(P0), physics=phys)
    P = sim.P
    dt = float(sim.compute_dt())
    print(f"grid {n}^3, dt={dt:.3e}")

    mp = phys.mp
    rt_def = mp.default_rt(P)

    # 1. raytrace alone (jitted)
    tracer = phys.raytracer.point_tracers[0]

    @jax.jit
    def do_trace(Ph):
        ds0 = jnp.asarray(tracer.ds)
        dtau = phys.dtau_for(phys.sources[0], Ph, ds0)
        return tracer.trace(dtau)

    timed("raytrace (1 point source)", do_trace, P)

    # 2. ydot alone
    nHv = mp.n_H(P[RO])
    Eint = P[PG] / (mpc.gamma - 1.0)
    omx = jnp.clip(1.0 - P[mpc.tracer_slot], 1e-20, 1.0 - 1e-20)

    @jax.jit
    def do_ydot(omx, Eint, nHv):
        return mp.ydot(omx, Eint, nHv, rt_def)

    timed("ydot (1 eval, default rt)", do_ydot, omx, Eint, nHv)

    # rt with real trace for realistic tau distribution
    rt_real = jax.jit(lambda Ph: phys.raytrace(Ph))(P)
    jax.block_until_ready(rt_real)

    @jax.jit
    def do_ydot_rt(omx, Eint, nHv):
        return mp.ydot(omx, Eint, nHv, rt_real)

    timed("ydot (1 eval, real rt)", do_ydot_rt, omx, Eint, nHv)

    # 3. one newton iteration cost (ydot + 2 jvp)
    @jax.jit
    def do_newton_rhs(omx, Eint, nHv):
        f0, f1v = mp.ydot(omx, Eint, nHv, rt_real)
        (j00, j10) = jax.jvp(lambda a: mp.ydot(a, Eint, nHv, rt_real),
                             (omx,), (jnp.ones_like(omx),))[1]
        (j01, j11) = jax.jvp(lambda b: mp.ydot(omx, b, nHv, rt_real),
                             (Eint,), (jnp.ones_like(Eint),))[1]
        return f0 + j00 + j01, f1v + j10 + j11

    timed("newton rhs (ydot + 2 JVP)", do_newton_rhs, omx, Eint, nHv)

    # 4. full mp update
    @jax.jit
    def do_update(P):
        return mp._update_impl(P, dt, cfg, rt_real)

    timed("mp update (euler+stiff ladder)", do_update, P, k=2)

    # 5. mp_delta_U (includes trace)
    @jax.jit
    def do_dU(P):
        return phys.mp_delta_U(P, P, dt, cfg)

    timed("mp_delta_U (trace + update)", do_dU, P, k=2)

    # 6. full coupled advance
    timed("full advance (OA2 coupled)",
          lambda P: sim.fns.advance(P, dt, 0.0), P, k=2)

    # 7. pure dynamics advance
    sim_dyn = Simulation(cfg, jnp.asarray(P0))
    timed("pure dynamics advance", lambda P: sim_dyn.fns.advance(P, dt, 0.0),
          P, k=5)


if __name__ == "__main__":
    main()
