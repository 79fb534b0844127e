"""The accelerator question, answered in one place; the compile cache; and
the jit that keeps set-up arrays out of the compiled step programs.

The program runs on NVIDIA GPUs; the CPU backend serves the tests.  Every
caller that needs to know whether it is on the accelerator asks
:func:`on_gpu`; entry points that must not run without one call
:func:`require_gpu`.
"""
from __future__ import annotations

import inspect
import os
from typing import Optional

import jax
import numpy as np

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
CACHE_MAX_ENV = "JAX_COMPILATION_CACHE_MAX_SIZE"
# closed-over arrays of at least this size become program arguments
HOIST_MIN_BYTES = 1 << 12


def on_gpu() -> bool:
    """True when JAX's default backend is a GPU."""
    return jax.default_backend() == "gpu"


def require_gpu() -> None:
    """Raise unless JAX runs on a GPU (no CPU fallback)."""
    if not on_gpu():
        raise RuntimeError(
            f"no GPU: JAX's default backend is {jax.default_backend()!r} "
            f"with devices {jax.devices()}")


def compile_cache_dir() -> Optional[str]:
    """Directory the program sets for JAX's persistent compile cache:
    ``<checkout>/.jax_cache``, or None when ``JAX_COMPILATION_CACHE_DIR``
    is set (JAX then reads the variable itself)."""
    if os.environ.get(CACHE_ENV):
        return None
    return os.path.join(CHECKOUT, ".jax_cache")


def use_compile_cache() -> Optional[str]:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`
    (the coupled step programs take minutes to compile cold).  Returns the
    directory set in code, or None when the environment chose it."""
    path = compile_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    if not os.environ.get(CACHE_MAX_ENV):
        # JAX's default cap silently skips programs above ~200 MB
        jax.config.update("jax_compilation_cache_max_size", -1)
    return path


class HoistedJit:
    """``jax.jit(fn)`` that passes fn's large closed-over arrays (masks,
    geometry, raytrace weights built at set-up) to the compiled program as
    arguments instead of embedding them as constants.

    Embedded, each per-cell array of a 128^3 level is 8-16 MB of literal
    data in the executable: the float32 coupled nested-grid step was
    ~185 MiB, too large for JAX's compile cache, and took about twice as
    long to compile.
    The arrays are placed on the device once per input signature (replicated
    over the mesh when the inputs are sharded).  Call it like the jitted
    function; :meth:`lower` lowers the program that runs.
    """

    def __init__(self, fn):
        self._fn = fn
        self._sig = inspect.signature(fn)
        self._programs = {}

    def _bind(self, args, kwargs):
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        leaves, tree = jax.tree.flatten(bound.args)
        key = (tree, tuple(jax.typeof(x) for x in leaves),
               jax.config.read("jax_enable_x64"))
        if key not in self._programs:
            self._programs[key] = self._build(bound.args, leaves)
        return self._programs[key], leaves

    def _build(self, args, leaves):
        closed, out_shape = jax.make_jaxpr(self._fn, return_shape=True)(
            *args)
        jaxpr, consts = closed.jaxpr, list(closed.consts)
        big = [i for i, c in enumerate(consts) if hasattr(c, "shape")
               and np.size(c) * np.dtype(c.dtype).itemsize >= HOIST_MIN_BYTES]
        mesh = next((x.sharding.mesh for x in leaves
                     if isinstance(getattr(x, "sharding", None),
                                   jax.sharding.NamedSharding)
                     and x.sharding.mesh.size > 1), None)
        place = (jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
                 if mesh is not None else None)
        hoisted = [jax.device_put(consts[i], place) for i in big]
        for i in big:
            consts[i] = None
        out_tree = jax.tree.structure(out_shape)

        def program(hoisted, *flat):
            full = list(consts)
            for i, c in zip(big, hoisted):
                full[i] = c
            return jax.core.eval_jaxpr(jaxpr, full, *flat)

        return jax.jit(program), hoisted, out_tree

    def __call__(self, *args, **kwargs):
        (fn, hoisted, out_tree), leaves = self._bind(args, kwargs)
        return jax.tree.unflatten(out_tree, fn(hoisted, *leaves))

    def lower(self, *args, **kwargs):
        (fn, hoisted, _), leaves = self._bind(args, kwargs)
        return fn.lower(hoisted, *leaves)
