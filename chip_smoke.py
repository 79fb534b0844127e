"""Smoke test of pion_tpu on an NVIDIA GPU, through the command-line entry
points (``icgen`` / ``run``) at the flagship's full size.

    python chip_smoke.py              # one GPU: every phase below but the last
    python chip_smoke.py --cards 4    # four GPUs: the sharded phase only

Phases (one GPU):
  1. device     — JAX must run on a GPU; prints its kind and nvidia-smi's
                  name and power limit.
  2. dynamics   — params/blastwave3d_glm_256.txt (256^3 f32 GLM-MHD blast),
                  10 steps: finite fields, t > 0, mass conserved to 1e-5.
  3. flagship   — params/ostar3d_class_coupled.txt (128^3 x 2 levels, MPv3 +
                  point source + wind), 4 natural hierarchy steps in float32
                  and in float64: finite fields, ionization beyond the wind
                  region, a carved free-wind cavity; then the same run from
                  a CPU child process (JAX_PLATFORMS=cpu, started first, it
                  never opens the card): the same dt at every step, and
                  per variable max|gpu-cpu| / max|cpu| within a bound.
The float32 phases run first: float64 switches JAX's x64 mode on for the
rest of the process.

With ``--cards 4``: the flagship in f32 sharded over four GPUs
(``mesh=auto``) against the same run on one card (``mesh=off``), in one
process, with the compiled step's collective counts.

The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``; any failed phase exits non-zero before it.
"""
import argparse
import contextlib
import gc
import glob
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
FLAGSHIP = os.path.join(ROOT, "params", "ostar3d_class_coupled.txt")
BLAST = os.path.join(ROOT, "params", "blastwave3d_glm_256.txt")
# GPU-vs-CPU bound per dtype on max|gpu - cpu| / max|cpu| of each variable
# (CHANGES.md states what holds and why)
CPU_BOUNDS = {"float32": 2e-4, "float64": 1e-9}
LOGGED_DT_RTOL = 1e-6    # the run log prints dt to 7 significant digits
SHARDED_BOUND = 2e-4     # f32 reassociation across shards


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def fresh_dir(name):
    path = os.path.join(WORK, name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def memory():
    """Device bytes in use now, and the process's peak so far (JAX has no
    per-phase peak)."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}   # None on the CPU
    return (f"bytes_in_use={stats.get('bytes_in_use')}, "
            f"process peak_bytes_in_use={stats.get('peak_bytes_in_use')}")


def run_logged(argv):
    """``run_main(argv)`` with its per-step log lines (log_freq=1) echoed
    as they come; returns the Simulation and the dt of every step."""
    from pion_tpu.cli import run_main

    out = sys.stdout

    class Tee(io.StringIO):
        def write(self, s):
            out.write(s)
            out.flush()
            return super().write(s)

    buf = Tee()
    with contextlib.redirect_stdout(buf):
        sim = run_main(argv + ["log_freq=1"])
    return sim, step_dts(buf.getvalue())


def step_dts(text):
    """The dt of each step from the run loop's log lines."""
    return [float(v) for v in re.findall(r"dt: (\S+)", text)]


def steady_step_seconds(sim, k=2):
    """Mean wall time of k more steps (compiled; step() syncs on dt)."""
    import jax

    t0 = time.perf_counter()
    for _ in range(k):
        sim.step()
    jax.block_until_ready(sim.P)
    return (time.perf_counter() - t0) / k


def check_flagship(sim, steps):
    """Finite fields, ionization on level 1 beyond the wind region (whose
    cells the wind sets ionized) and a carved wind cavity (free-wind density
    near the star far below ambient, flowing outward along +x)."""
    from pion_tpu.constants import RO, VX

    check(sim.step_count == steps and sim.t > 0.0,
          f"steps={sim.step_count} t={sim.t}")
    levels = [np.asarray(p) for p in sim.P]
    for lev, P in enumerate(levels):
        check(np.all(np.isfinite(P)), f"non-finite state on level {lev}")
    cfg_f = sim.cfgs[1]
    wind = sim.physics.wind_sources[0]
    ax = [np.asarray(cfg_f.cell_centers(a)) - wind.position[a]
          for a in range(3)]
    Z, Y, X = np.meshgrid(*ax, indexing="ij")
    r = np.sqrt(X * X + Y * Y + Z * Z)
    Pf = levels[1]
    # the I-front beyond the wind region: ambient x(H+) is 1e-6
    x_out = float(Pf[cfg_f.eqn.nbase][r > wind.radius + cfg_f.dx].max())
    check(x_out > 1.0e-3, f"no ionization beyond the wind region: {x_out}")
    iz, iy = np.argmin(np.abs(ax[0])), np.argmin(np.abs(ax[1]))
    ix = np.argmin(np.abs(ax[2] - 4.5 * cfg_f.dx))
    rho_amb = float(levels[0][RO].max())
    rho_w, vx_w = float(Pf[RO][iz, iy, ix]), float(Pf[VX][iz, iy, ix])
    check(rho_w < 0.1 * rho_amb and vx_w > 0.5 * wind.vinf,
          f"no wind cavity: rho={rho_w} (ambient {rho_amb}) vx={vx_w}")
    return x_out, rho_w / rho_amb, vx_w


def relative_errors(a, b):
    """Per variable max|a-b| / max|a| over all levels; (nlev, nvar, ...)."""
    out = []
    for v in range(a.shape[1]):
        av = a[:, v].astype(np.float64)
        bv = b[:, v].astype(np.float64)
        scale = np.max(np.abs(av))
        diff = np.max(np.abs(av - bv))
        out.append(diff / scale if scale > 0.0 else diff)
    return np.asarray(out)


# -- phases -----------------------------------------------------------------

def phase_device(cards):
    import jax

    from pion_tpu.device import require_gpu

    require_gpu()
    devs = jax.devices()
    check(len(devs) >= cards, f"need {cards} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    log(f"device: {devs[0].device_kind} x{len(devs)} "
        f"(platform {devs[0].platform}, jax {jax.__version__})")
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line.strip()}")


def phase_dynamics(n=256, steps=10):
    from pion_tpu.cli import icgen_main, run_main
    from pion_tpu.constants import RO
    from pion_tpu.io import load_snapshot

    out = fresh_dir("dynamics")
    ov = [f"NGridX={n}", f"NGridY={n}", f"NGridZ={n}", f"OutputPath={out}/"]
    t0 = time.perf_counter()
    snap = icgen_main([BLAST] + ov)
    t_ic = time.perf_counter() - t0
    _cfg, P0, _t, _s = load_snapshot(snap)
    check(P0.dtype == np.float32, f"state dtype {P0.dtype}")
    mass0 = float(P0[RO].sum(dtype=np.float64))
    del P0
    t0 = time.perf_counter()
    sim = run_main([snap, f"max_steps={steps}"])
    t_run = time.perf_counter() - t0
    P = np.asarray(sim.P)
    check(sim.step_count == steps and sim.t > 0.0,
          f"steps={sim.step_count} t={sim.t}")
    check(np.all(np.isfinite(P)), "non-finite state")
    dmass = abs(float(P[RO].sum(dtype=np.float64)) / mass0 - 1.0)
    check(dmass < 1.0e-5, f"mass not conserved: relative change {dmass}")
    del P
    t_step = steady_step_seconds(sim)
    log(f"dynamics {n}^3 f32: icgen {t_ic:.1f} s, run ({steps} steps incl. "
        f"compile) {t_run:.1f} s, steady step {t_step:.4f} s, t={sim.t:.4e}, "
        f"|dmass|/mass={dmass:.2e}, {memory()}")
    del sim
    shutil.rmtree(out)


def flagship_overrides(n, outdir, name, dtype):
    """Param overrides: n cells per level, the wind boundary region kept at
    6 fine cells, the final snapshot to ``outdir/name``."""
    from pion_tpu.io.params import read_paramfile

    p = read_paramfile(FLAGSHIP)
    fine_dx = (float(p["Xmax"]) - float(p["Xmin"])) / (2 * n)
    ov = [f"NGridX={n}", f"NGridY={n}", f"NGridZ={n}",
          f"WIND_0_radius={6.0 * fine_dx!r}",
          f"OutputPath={outdir}/", f"OutputFile={name}"]
    # float64 is the CLI default: leave the key unset for it
    return ov if dtype == "float64" else ov + [f"dtype={dtype}"]


def start_cpu_reference(dtype, n, steps):
    """The flagship's ICs (icgen, host-only work) and a ``run`` of them in
    a child process on the CPU backend."""
    from pion_tpu.cli import icgen_main

    out = fresh_dir(f"cpu_{dtype}")
    snap = icgen_main([FLAGSHIP] + flagship_overrides(n, out, "flagship",
                                                      dtype))
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    logf = open(os.path.join(out, "child.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pion_tpu", "run", snap,
         f"max_steps={steps}", "log_freq=1"],
        cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT)
    return proc, logf, out


def phase_flagship(dtype, child, n=128, steps=4):
    """The flagship through icgen + run on the GPU: physics checks, then
    the final snapshot against the CPU child's.  Returns None, or what
    exceeded the GPU-vs-CPU bound."""
    from pion_tpu.cli import icgen_main
    from pion_tpu.io import load_snapshot

    out = fresh_dir(f"flagship_{dtype}")
    ov = flagship_overrides(n, out, "flagship", dtype)
    t0 = time.perf_counter()
    snap = icgen_main([FLAGSHIP] + ov)
    t_ic = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim, dts = run_logged([snap, f"max_steps={steps}"])
    t_run = time.perf_counter() - t0
    check(sim.P[0].dtype == np.dtype(dtype), f"state dtype {sim.P[0].dtype}")
    x_out, rho_ratio, vx_w = check_flagship(sim, steps)
    t_step = steady_step_seconds(sim)
    log(f"flagship {n}^3 x 2 {dtype}: icgen {t_ic:.1f} s, run ({steps} "
        f"steps incl. compile) {t_run:.1f} s, steady hierarchy step "
        f"{t_step:.4f} s, t={sim.t:.4e}, max x(H+) beyond wind={x_out:.3e}, "
        f"cavity rho/ambient={rho_ratio:.2e} vx={vx_w:.3e}, {memory()}")
    del sim

    proc, logf, cpu_out = child
    t0 = time.perf_counter()
    rc = proc.wait(timeout=1200)
    logf.close()
    if rc != 0:
        with open(logf.name) as f:
            sys.stderr.write(f.read()[-4000:])
        raise RuntimeError(f"CPU reference run failed with exit code {rc}")
    t_wait = time.perf_counter() - t0
    with open(logf.name) as f:
        cpu_dts = step_dts(f.read())
    check(len(dts) == len(cpu_dts) == steps,
          f"step logs: gpu {dts} cpu {cpu_dts}")
    dt_err = max(abs(a - b) / b for a, b in zip(dts, cpu_dts))
    log(f"gpu vs cpu {n}^3 x 2 {dtype} dt per step: gpu {dts}, cpu "
        f"{cpu_dts}, max relative difference {dt_err:.3e}")
    name = f"flagship.{steps:08d}*"
    gpu_snap = glob.glob(os.path.join(out, name))
    cpu_snap = glob.glob(os.path.join(cpu_out, name))
    check(len(gpu_snap) == 1 and len(cpu_snap) == 1,
          f"final snapshots: {gpu_snap} {cpu_snap}")
    _c, Pg, tg, _s = load_snapshot(gpu_snap[0])
    _c, Pc, tc, _s = load_snapshot(cpu_snap[0])
    check(Pg.dtype == Pc.dtype == np.dtype(dtype),
          f"dtypes {Pg.dtype} {Pc.dtype}")
    check(np.all(np.isfinite(Pc)), "non-finite CPU state")
    err = relative_errors(Pc, Pg)
    dt_rel = abs(tg - tc) / tc
    log(f"gpu vs cpu {n}^3 x 2 {dtype}: t {tg:.6e} vs {tc:.6e}, per-variable "
        f"max|gpu-cpu|/max|cpu| = {np.array2string(err, precision=3)}, "
        f"bound {CPU_BOUNDS[dtype]:.0e} (waited {t_wait:.1f} s for the CPU)")
    shutil.rmtree(out)
    shutil.rmtree(cpu_out)
    bound = CPU_BOUNDS[dtype]
    if (dt_err > max(bound, LOGGED_DT_RTOL) or dt_rel > bound
            or np.any(err > bound)):
        # reported after the remaining phases have run; the smoke fails
        return (f"{dtype} GPU and CPU differ beyond {bound}: dt {dt_err}, "
                f"t {dt_rel}, fields {err}")
    return None


def timed(fn, *a):
    t0 = time.perf_counter()
    out = fn(*a)
    return out, time.perf_counter() - t0


def phase_four_cards(n=128, steps=4):
    from pion_tpu.parallel.mesh import collective_counts

    out = fresh_dir("sharded")
    base = [FLAGSHIP, f"max_steps={steps}"]
    (sim, dts4), t_run = timed(run_logged, base + flagship_overrides(
        n, out, "mesh4", "float32") + ["mesh=auto"])
    log(f"sharded run (incl. compile) {t_run:.1f} s")
    (sim1, dts1), t_run1 = timed(run_logged, base + flagship_overrides(
        n, out, "mesh1", "float32") + ["mesh=off"])
    ndev = [len(p.sharding.device_set) for p in sim.P]
    check(all(k == 4 for k in ndev), f"state sharded over {ndev} devices")
    check(len(sim1.P[0].sharding.device_set) == 1, "mesh=off run sharded")
    x_out, _r, _v = check_flagship(sim, steps)
    sp = sim.physics.update_sources(sim.t)
    hlo = (sim._fused_step_fn()
           .lower(tuple(sim.P), sim.t, sim.last_dt, sim._dt_cap(), sp)
           .compile().as_text())
    counts = collective_counts(hlo)
    log(f"sharded flagship {n}^3 x 2 f32 on {ndev[0]} GPUs "
        f"(mesh {dict(sim.mesh.shape)}): run ({steps} steps incl. compile) "
        f"{t_run:.1f} s, max x(H+) beyond wind={x_out:.3e}; compiled step: "
        f"{counts['all-gather']} all-gather, "
        f"{counts['collective-permute']} collective-permute")
    P4 = np.stack([np.asarray(p) for p in sim.P])
    P1 = np.stack([np.asarray(p) for p in sim1.P])
    t4, t1 = sim.t, sim1.t
    t_step4 = steady_step_seconds(sim)
    t_step1 = steady_step_seconds(sim1)
    err = relative_errors(P1, P4)
    dt_rel = abs(t4 - t1) / t1
    log(f"one card (mesh=off): run {t_run1:.1f} s; steady hierarchy step "
        f"4 cards {t_step4:.4f} s, 1 card {t_step1:.4f} s; t rel diff "
        f"{dt_rel:.3e}; per-variable max|4-1|/max|1| = "
        f"{np.array2string(err, precision=3)}, bound {SHARDED_BOUND:.0e}; "
        f"dt per step 4 cards {dts4}, 1 card {dts1}; device 0 {memory()}")
    check(dt_rel <= SHARDED_BOUND, f"time differs: {dt_rel}")
    check(np.all(err <= SHARDED_BOUND),
          f"4-card and 1-card runs differ beyond {SHARDED_BOUND}: {err}")
    shutil.rmtree(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-GPU sharded phase")
    args = ap.parse_args(argv)

    from pion_tpu.device import use_compile_cache

    use_compile_cache()
    try:
        phase_device(args.cards)
    except RuntimeError as e:
        sys.exit(f"chip_smoke: {e}")
    import jax

    os.makedirs(WORK, exist_ok=True)
    children = {}
    try:
        t_all = time.perf_counter()
        failed = []

        def run(phase, *a):
            log(f"[{time.perf_counter() - t_all:.0f} s] {phase.__name__}"
                f"{a[:1]}")
            msg = phase(*a)
            gc.collect()
            if msg:
                failed.append(msg)

        if args.cards == 4:
            run(phase_four_cards)
        else:
            # CPU references first, so they run while the GPU phases do
            for dt in ("float32", "float64"):
                children[dt] = start_cpu_reference(dt, 128, 4)
            run(phase_dynamics)
            run(phase_flagship, "float32", children["float32"])
            run(phase_flagship, "float64", children["float64"])
        check(not failed, "; ".join(failed))
        log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    finally:
        for proc, logf, _out in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logf.close()
        shutil.rmtree(WORK, ignore_errors=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
