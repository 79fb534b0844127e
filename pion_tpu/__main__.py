"""``python -m pion_tpu {icgen,run} ...`` — the reference's binaries
(reference: bin_serial/Makefile:389-400 pion-ugs/icgen-ugs targets).

The backend follows ``JAX_PLATFORMS``; the persistent compile cache
follows ``JAX_COMPILATION_CACHE_DIR``, or ``<checkout>/.jax_cache`` when
that is unset (see :mod:`pion_tpu.device`).
"""
from .device import use_compile_cache
from .cli import main

if __name__ == "__main__":
    import sys

    use_compile_cache()
    sys.exit(main())
