"""Test configuration: CPU backend with 8 virtual devices, f64 enabled.

The tests run on the CPU (``JAX_PLATFORMS=cpu``; forced here as well) and
exercise multi-device code on a virtual device mesh.  What only runs on
the GPU is a phase of ``chip_smoke.py`` at the repository root.

Mirrors the reference test strategy (SURVEY.md §4): physics regression
problems compared against analytic solutions, plus nproc-invariance checks
on a virtual device mesh (the comm_files/mpirun-oversubscribe equivalent).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from pion_tpu.device import use_compile_cache  # noqa: E402

# Persistent compile cache: the suite re-jits the same step functions on
# every run; caching cuts multi-minute reruns to seconds.
use_compile_cache()
