"""Explicit halo-exchange stepping under ``shard_map``.

The GSPMD path (jit over NamedSharding'd arrays) lets XLA infer the halo
collectives; this module is the hand-scheduled equivalent of the reference's
MPI halo machinery (reference: source/boundaries/MCMD_boundaries.cpp pack ->
``COMM->send_cell_data``/``receive_cell_data`` -> unpack): each shard pads
its local block with ghost strips received from its mesh neighbours
(``lax.ppermute``), applies physical boundary conditions only on shards that
own a domain edge, and runs the XLA sweep on the local block.  dt reduction
is a ``lax.pmin`` — the reference's MPI_Allreduce
(sim_control_MPI.cpp:503-504).

Scope: BCs whose ghost values derive from local edge data (periodic,
outflow, one-way, reflecting, jetreflect, axisymmetric).  Globally-indexed
BCs (DMR, fixed strips, jets) and cross-shard raytracing stay on the GSPMD
path for now.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..boundaries import BC, BoundaryData, _pad_axis
from ..config import SimConfig
from ..constants import Eqn
from ..grid import Geometry
from ..ops.timestep import dynamics_dt

_LOCAL_BCS = (BC.PERIODIC, BC.OUTFLOW, BC.ONEWAY_OUT, BC.REFLECTING,
              BC.JETREFLECT, BC.AXISYMMETRIC)


def supports(cfg: SimConfig) -> bool:
    return all(lo in _LOCAL_BCS and hi in _LOCAL_BCS for lo, hi in cfg.bcs)


def _slab(A, ax, lo, hi):
    idx = [slice(None)] * A.ndim
    idx[ax] = slice(lo, hi)
    return A[tuple(idx)]


def _pad_axis_sharded(out, cfg: SimConfig, axis: int, bdata, name: str,
                      m: int, t):
    """Pad one axis: ghost strips from mesh neighbours via ppermute, with
    physical BCs on the shards owning a domain edge."""
    ng = cfg.ng
    ax = 1 + axis
    lo_bc_kind, hi_bc_kind = cfg.bcs[axis]

    hi_edge = _slab(out, ax, out.shape[ax] - ng, None)
    lo_edge = _slab(out, ax, 0, ng)
    # receive the LEFT neighbour's high edge as our low ghost, and vice versa
    recv_lo = jax.lax.ppermute(hi_edge, name,
                               [(i, (i + 1) % m) for i in range(m)])
    recv_hi = jax.lax.ppermute(lo_edge, name,
                               [(i, (i - 1) % m) for i in range(m)])

    # physical BC ghosts computed from local edge data (valid only on the
    # edge-owning shards; selected below)
    padded_bc = _pad_axis(out, cfg, axis, bdata, t=t)
    lo_bc = _slab(padded_bc, ax, 0, ng)
    hi_bc = _slab(padded_bc, ax, padded_bc.shape[ax] - ng, None)

    idx = jax.lax.axis_index(name)
    if lo_bc_kind is BC.PERIODIC:
        lo = recv_lo  # the ring permute wraps the domain
    else:
        lo = jnp.where(idx == 0, lo_bc, recv_lo)
    if hi_bc_kind is BC.PERIODIC:
        hi = recv_hi
    else:
        hi = jnp.where(idx == m - 1, hi_bc, recv_hi)
    return jnp.concatenate([lo, out, hi], axis=ax)


def apply_bcs_sharded(P_local, cfg: SimConfig, bdata, mesh: Mesh, t=0.0):
    names = mesh.axis_names
    out = P_local
    for axis in range(cfg.ndim):
        name = names[axis]
        m = mesh.shape[name]
        if m == 1:
            out = _pad_axis(out, cfg, axis, bdata, t=t)
        else:
            out = _pad_axis_sharded(out, cfg, axis, bdata, name, m, t)
    return out


def make_sharded_step(cfg: SimConfig, geom: Geometry, mesh: Mesh,
                      bdata: Optional[BoundaryData] = None):
    """Jitted (advance, calc_dt) over an explicit shard_map.

    The per-shard geometry is uniform (Cartesian requirement), so each shard
    runs the identical local sweep; only ghost strips cross devices.
    """
    from ..ops.sweep import dynamics_dU
    from ..stepper import cell_advance, glm_psi_damp

    assert supports(cfg), "sharded path requires local-data BCs"
    from ..constants import Coord

    assert cfg.coords is Coord.CARTESIAN, \
        "sharded halo path: Cartesian only (radial metric is global)"
    if bdata is None:
        bdata = BoundaryData()
    names = mesh.axis_names
    spec = P(None, *names)

    # local geometry: same dx; per-shard cfg has the local shape
    local_shape = tuple(cfg.shape[a] // mesh.shape[names[a]]
                        for a in range(cfg.ndim))
    cfg_local = cfg.with_(shape=local_shape,
                          xmax=tuple(cfg.xmin[a] + cfg.dx * local_shape[a]
                                     for a in range(cfg.ndim)))
    from ..grid import make_geometry

    geom = make_geometry(cfg_local)  # uniform Cartesian: same dx everywhere

    def _partial(P_prev, Ph, dt, order, ch, t):
        Ppad = apply_bcs_sharded(Ph, cfg_local, bdata, mesh, t)
        dU, _ = dynamics_dU(Ppad, cfg_local, geom, dt, order, ch=ch)
        Pnew = cell_advance(P_prev, dU, cfg_local)
        if cfg.eqn is Eqn.GLM:
            Pnew = glm_psi_damp(Pnew, dt, ch, cfg_local, geom)
        return Pnew

    def _advance_local(P_local, dt, t):
        ch = cfg.cfl * geom.dx / dt if cfg.eqn is Eqn.GLM else None
        if cfg.ooa == 1:
            return _partial(P_local, P_local, dt, 1, ch, t)
        Ph = _partial(P_local, P_local, 0.5 * dt, 1, ch, t)
        return _partial(P_local, Ph, dt, 2, ch, t)

    def _dt_local(P_local):
        d = dynamics_dt(P_local, cfg_local, geom)
        for name in names:
            if mesh.shape[name] > 1:
                d = jax.lax.pmin(d, name)
        return d

    from jax import shard_map

    advance = jax.jit(shard_map(
        _advance_local, mesh=mesh,
        in_specs=(spec, P(), P()), out_specs=spec))
    calc_dt = jax.jit(shard_map(
        _dt_local, mesh=mesh, in_specs=(spec,), out_specs=P()))
    return advance, calc_dt
