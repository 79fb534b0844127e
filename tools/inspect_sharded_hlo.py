"""Dump the collective-op census of the sharded (GSPMD) step programs.

Answers "what does XLA actually emit for the halo pattern?" without the
cards: compiles the fused step over a 4-virtual-device CPU mesh (the 2x2x1
decomposition a 4-GPU host gets) and counts collectives in the optimized
HLO.  ``chip_smoke.py --cards 4`` prints the same census for the compiled
GPU step.  Sharded runs take the dense chemistry ladder and the GSPMD plane
sweep for the raytrace; the hand-scheduled alternative for pure dynamics is
``cfg.halo='explicit'`` (parallel/halo.py via Simulation).

    python tools/inspect_sharded_hlo.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp

def census(label, lowered):
    from pion_tpu.parallel.mesh import collective_counts

    print(f"{label}:")
    for name, k in collective_counts(lowered.compile().as_text()).items():
        print(f"  {name:20s} {k}")


def main():
    from pion_tpu import SimConfig
    from pion_tpu.constants import K_B, MSUN, PG, RO, YEAR
    from pion_tpu.ics import blast_wave
    from pion_tpu.microphysics import MPv3, MPv3Config
    from pion_tpu.parallel.mesh import make_mesh, shard_state
    from pion_tpu.physics import Physics
    from pion_tpu.raytracing import Source
    from pion_tpu.sim import Simulation
    from pion_tpu.winds import WindSource

    n = 32
    cfg = SimConfig(ndim=3, eqn="glm", solver="hlld", ntracer=1,
                    shape=(n,) * 3, xmin=(0.0,) * 3, xmax=(1.0,) * 3,
                    bcs=tuple([("outflow", "outflow")] * 3), cfl=0.3,
                    ooa=2, av="falle", etav=0.1, dtype="float32",
                    mesh="on")  # engage the sharded-run paths (dense
    # chemistry ladder) exactly as a real multi-GPU run
    mesh = make_mesh(cfg)
    P0 = jnp.asarray(blast_wave(cfg, B0=(0.1, 0.05, 0.0)).astype(np.float32))
    sim = Simulation(cfg, shard_state(P0, mesh, cfg))
    census("dynamics-only sharded step (GLM+HLLD)",
           sim.fns.step.lower(sim.P, 0.0, 0.0, 1e12, None))

    L = 3.0e18
    cfg_c = cfg.with_(eqn="euler", solver="hll", xmin=(0.0,) * 3,
                      xmax=(L,) * 3, min_temperature=50.0, tmax=1e16)
    mpc = MPv3Config(tracer_slot=cfg_c.eqn.nbase, ion_src="mono",
                     n_idot=1e48, min_temperature=50.0)
    ctr = (0.5 * L,) * 3
    phys = Physics(
        mp=MPv3(mpc),
        sources=[Source(position=ctr, strength=1e48, effect="mono")],
        wind_sources=[WindSource(position=ctr, radius=2.5 * cfg_c.dx,
                                 mdot=1e-7 * MSUN / YEAR, vinf=2e8,
                                 t_wind=3e4, tracers=(1.0,))],
        dt_limit=True)
    Pc = np.zeros((cfg_c.nvar,) + cfg_c.shape, np.float32)
    Pc[RO] = 10 * mpc.mean_mass_per_h
    Pc[PG] = 11 * K_B * 100.0
    Pc[cfg_c.eqn.nbase] = 1e-6
    simc = Simulation(cfg_c, shard_state(jnp.asarray(Pc), mesh, cfg_c),
                      physics=phys)
    census("coupled MPv3+RT+wind sharded step",
           simc.fns.step.lower(simc.P, 0.0, 0.0, 1e12, None))


if __name__ == "__main__":
    main()
