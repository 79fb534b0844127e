"""Head-to-head walltime benchmark on the reference's own documented case.

The reference's only published walltime: Ostar2 2D (256x128 cylindrical
GLM-MHD wind bubble with WSS09 cooling, params_Ostar2_B010_d2l1n0256.txt)
runs to FinishTime=1e13 s in ~15 minutes on 32 Kay cores
(/root/reference/test_problems/OpenMP/README.md:17-18, kay.*.txt).

This script icgens + runs the SAME param file through the pion_tpu CLI on
one GPU and reports walltime + step count.  Usage:
    python tools/bench_ostar2d.py [dtype] [finish_time]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pion_tpu.device import use_compile_cache  # noqa: E402

use_compile_cache()

import numpy as np

REF = ("/root/reference/test_problems/OpenMP/"
       "params_Ostar2_B010_d2l1n0256.txt")


def main():
    import tempfile

    from pion_tpu.cli import icgen_main, run_main

    dtype = sys.argv[1] if len(sys.argv) > 1 else "float32"
    tfin = float(sys.argv[2]) if len(sys.argv) > 2 else 1.0e13
    tmp = tempfile.mkdtemp()
    txt = open(REF).read().replace("OutputPath ./", f"OutputPath {tmp}/")
    pf = os.path.join(tmp, "params.txt")
    open(pf, "w").write(txt)
    snap = icgen_main([pf, f"dtype={dtype}"])
    t0 = time.perf_counter()
    sim = run_main([snap, f"FinishTime={tfin:.6e}", "log_freq=2048",
                    "OutputFrequency=0", "chunk=256"])
    wall = time.perf_counter() - t0
    P = np.asarray(sim.P)
    ok = bool(np.all(np.isfinite(P)))
    ups = sim.step_count * P.shape[-1] * P.shape[-2] / wall
    print(f"\nOstar2D {dtype}: t={sim.t:.4e}s steps={sim.step_count} "
          f"walltime={wall:.1f}s finite={ok} "
          f"({ups/1e6:.2f}M cell-updates/s incl. compile)")
    print("reference: ~900 s on 32 Kay cores (OpenMP/README.md:17-18) "
          f"-> speedup x{900.0/wall:.1f} on one GPU")


if __name__ == "__main__":
    main()
