"""Device-mesh spatial sharding (the MPI domain decomposition equivalent).

The reference decomposes each level into per-rank bricks with explicit
MPI halo exchange (reference: source/decomposition/MCMD_control.cpp:62-230,
source/boundaries/MCMD_boundaries.cpp).  Here the domain is one global dense
array sharded over a ``jax.sharding.Mesh``; stencil shifts on sharded arrays
compile to XLA collective-permutes between devices, so "halo exchange" is
emitted by the compiler rather than hand-written (GSPMD).  The same jitted
``advance`` runs on one card or several — only the shardings differ.

Mesh axes are named after the array axes they shard: ('z','y','x') for 3D.
Like the reference (MCMD_control.cpp nx search: most-divided along Z then Y
then X), we put more shards on the slower axes first, keeping the fast
(contiguous) axis (x) whole when possible.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SimConfig
from ..device import on_gpu

AXIS_NAMES = ("z", "y", "x")


def decompose(n_devices: int, ndim: int, shape: Sequence[int]) -> Tuple[int, ...]:
    """Split n_devices into per-axis factors, most-divided on the slowest
    axis (reference: MCMD_control.cpp:62-230 'nx' search)."""
    factors = [1] * ndim
    remaining = n_devices
    # greedy: repeatedly assign the smallest prime factor to the axis with
    # the largest cells-per-shard
    primes = []
    m = remaining
    p = 2
    while m > 1:
        while m % p == 0:
            primes.append(p)
            m //= p
        p += 1
    for prime in sorted(primes, reverse=True):
        ax = int(np.argmax([shape[i] / factors[i] for i in range(ndim)]))
        factors[ax] *= prime
    return tuple(factors)


def make_mesh(cfg: SimConfig, n_devices: Optional[int] = None,
              devices=None) -> Mesh:
    """Build the spatial device mesh: the devices (all visible ones by
    default, or the first ``n_devices``) reshaped to the
    :func:`decompose` factors.  The cards of one host are joined all to
    all, so device placement does not matter."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[: n_devices]
    factors = decompose(len(devices), cfg.ndim, cfg.shape)
    names = AXIS_NAMES[-cfg.ndim:]
    return Mesh(np.array(devices).reshape(factors), names)


def state_sharding(mesh: Mesh, cfg: SimConfig) -> NamedSharding:
    """State arrays (nvar, *spatial): variable axis replicated, spatial axes
    sharded along the mesh."""
    spec = P(None, *mesh.axis_names)
    return NamedSharding(mesh, spec)


def shard_state(Pstate, mesh: Mesh, cfg: SimConfig):
    return jax.device_put(Pstate, state_sharding(mesh, cfg))


def mesh_requested(cfg) -> bool:
    """Shard-on-construction gate for cfg.mesh (see SimConfig.mesh)."""
    if len(jax.devices()) <= 1:
        return False
    if cfg.mesh == "on":
        return True
    return cfg.mesh == "auto" and on_gpu()


def maybe_distributed_init() -> bool:
    """Multi-host bootstrap (the COMM->init equivalent of the reference
    binaries, main_NG_MPI.cpp:40-60): call ``jax.distributed.initialize``
    when standard cluster environment variables are present.  Idempotent;
    returns True when running multi-process."""
    import os

    # process_count() would start the backends, after which initialize()
    # is refused: ask the distributed client instead
    if jax.distributed.is_initialized():
        return jax.process_count() > 1
    markers = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
               "SLURM_JOB_ID")
    if not any(os.environ.get(m) for m in markers):
        return False
    try:
        jax.distributed.initialize()
    except (RuntimeError, ValueError):
        # already initialized, or single-process env that happens to set a
        # marker (e.g. SLURM_JOB_ID on a login shell): stay single-process
        return jax.process_count() > 1
    return jax.process_count() > 1


COLLECTIVES = ("all-gather", "collective-permute", "all-reduce",
               "all-to-all", "reduce-scatter")


def collective_counts(hlo_text: str) -> Dict[str, int]:
    """Collective instructions in compiled HLO text, by opcode (sync ops and
    the -start half of async pairs; instruction names do not count)."""
    return {op: len(re.findall(rf"\s{op}(?:-start)?\(", hlo_text))
            for op in COLLECTIVES}
