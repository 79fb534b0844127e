"""External boundary conditions as pure pad functions.

The reference implements each BC as an assign/update class pair operating on
ghost-cell linked lists (reference: source/boundaries/*_boundaries.cpp,
orchestrated by assign_update_bcs.cpp).  Here a boundary condition is simply
a rule for filling the ``ng`` ghost layers while padding the state array —
``apply_bcs`` maps ``(nvar, *shape) -> (nvar, *(shape+2*ng))`` and is traced
straight into the jitted step, so XLA fuses the pads with the stencil reads.

Sign conventions for mirror-type BCs follow the reference exactly:
  - reflecting: negate normal v and normal B (reflecting_boundaries.cpp:36-76)
  - jetreflect: negate normal v and TANGENTIAL B (jetreflect_boundaries.cpp:50-66)
  - axisymmetric (R=0): negate v_R, v_theta, B_R, B_theta
    (axisymmetric_boundaries.cpp:40-57)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from .config import SimConfig
from .constants import BC, BX, BY, BZ, VX, VY, VZ, Eqn


@dataclasses.dataclass(frozen=True)
class BoundaryData:
    """Static per-face data for value-carrying BCs.

    ``fixed[(axis, side)]`` holds a ghost-strip array of shape
    (nvar, ..., ng, ...) — the frozen inflow/fixed state for that face
    (reference: inflow_boundaries.cpp / fixed_boundaries.cpp store refval).
    ``jet`` optionally holds (radius_physical, state_vector) for a jet
    inflow region on a BC.JET face (reference: jet_boundaries.cpp: inflow
    within JP.jetradius of the axis, reflecting outside).
    """

    fixed: Dict[Tuple[int, int], np.ndarray] = dataclasses.field(default_factory=dict)
    jet: Optional[Tuple[float, np.ndarray]] = None

    def __hash__(self):
        return hash(
            (
                tuple(sorted((k, v.tobytes()) for k, v in self.fixed.items())),
                None
                if self.jet is None
                else (self.jet[0], self.jet[1].tobytes()),
            )
        )

    def __eq__(self, other):
        return isinstance(other, BoundaryData) and hash(self) == hash(other)


# Double-Mach-reflection states (reference:
# double_Mach_ref_boundaries.cpp:39-44 pre-shock, :189-194 post-shock).
DMR_POST = (8.0, 116.5, 7.14470958, -4.125, 0.0)
DMR_PRE = (1.4, 1.0, 0.0, 0.0, 0.0)


def _dmr_state(cfg: SimConfig, shape_like, x, y, t):
    """Post/pre-shock state selected by the oblique shock position
    x_s(y,t) = 10 t/sin(60deg) + 1/6 + y/tan(60deg) (reference: :184-198)."""
    import jax.numpy as jnp_

    bpos = 10.0 * t / np.sin(np.pi / 3.0) + 1.0 / 6.0 + y / np.tan(np.pi / 3.0)
    post_mask = x <= bpos
    vals = []
    for v in range(cfg.nvar):
        pv = DMR_POST[v] if v < 5 else 1.0
        qv = DMR_PRE[v] if v < 5 else -1.0
        vals.append(jnp_.where(post_mask, pv, qv))
    return jnp_.stack(vals)


def _mirror_signs(cfg: SimConfig, axis: int, kind: BC) -> np.ndarray:
    """Per-variable sign multipliers for mirror-type ghost cells."""
    sg = np.ones(cfg.nvar)
    k = cfg.ndim - 1 - axis  # physical axis index (x=0 is last array axis)
    if kind in (BC.REFLECTING, BC.JETREFLECT):
        sg[VX + k] = -1.0
        if cfg.eqn.is_mhd:
            if kind is BC.REFLECTING:
                sg[BX + k] = -1.0
            else:  # jetreflect: tangential B reversed
                for j in range(3):
                    if j != k:
                        sg[BX + j] = -1.0
    elif kind is BC.AXISYMMETRIC:
        # 2D (R,z): radial = VY, theta = VZ in PION's slot convention
        sg[VY] = -1.0
        sg[VZ] = -1.0
        if cfg.eqn.is_mhd:
            sg[BY] = -1.0
            sg[BZ] = -1.0
    return sg


def _pad_axis(P, cfg: SimConfig, axis: int, bdata: BoundaryData, t=0.0):
    """Pad one spatial axis with ng ghost layers on each side."""
    ng = cfg.ng
    lo_bc, hi_bc = cfg.bcs[axis]
    ax = 1 + axis  # array axis (variable index leads)
    k = cfg.ndim - 1 - axis

    n = P.shape[ax]

    def slab(lo, hi):
        # contiguous slice along ``ax`` — unlike jnp.take with an index
        # array this lowers to a plain slice, not a gather
        idx = [slice(None)] * P.ndim
        idx[ax] = slice(lo, hi)
        return P[tuple(idx)]

    def mirror(side: int, kind: BC):
        sg = jnp.asarray(_mirror_signs(cfg, axis, kind)).reshape(
            (-1,) + (1,) * cfg.ndim)
        strip = jnp.flip(
            slab(0, ng) if side == 0 else slab(n - ng, n), axis=ax)
        return strip * sg

    def ghost(side: int, kind: BC):
        # side: 0 = low face, 1 = high face; returns ng-layer strip ordered
        # outermost..innermost for lo, innermost..outermost for hi.
        if kind is BC.PERIODIC:
            return slab(n - ng, n) if side == 0 else slab(0, ng)
        if kind in (BC.OUTFLOW, BC.ONEWAY_OUT):
            edge = slab(0, 1) if side == 0 else slab(n - 1, n)
            edge = jnp.broadcast_to(
                edge, edge.shape[:ax] + (ng,) + edge.shape[ax + 1:])
            if kind is BC.ONEWAY_OUT:
                # clip inflow normal velocity to zero
                # (reference: oneway_out_boundaries.cpp:38-100)
                vslot = VX + k
                vn = edge[vslot]
                vn = jnp.minimum(vn, 0.0) if side == 0 else jnp.maximum(vn, 0.0)
                edge = edge.at[vslot].set(vn)
            return edge
        if kind in (BC.REFLECTING, BC.JETREFLECT, BC.AXISYMMETRIC):
            return mirror(side, kind)
        if kind in (BC.INFLOW, BC.FIXED):
            strip = bdata.fixed.get((axis, side))
            if strip is None:
                raise ValueError(
                    f"{kind} BC on axis {axis} side {side} needs BoundaryData.fixed"
                )
            return jnp.asarray(strip)
        if kind is BC.DMACH:
            # time-dependent oblique-shock top boundary of the double-Mach
            # reflection problem (reference: double_Mach_ref_boundaries.cpp
            # BC_update_DMACH:169-200); valid on the slow-axis hi face in 2D
            assert cfg.ndim == 2 and axis == 0 and side == 1
            x = jnp.asarray(cfg.cell_centers(1))[None, :]
            dxc = cfg.dx
            yg = cfg.xmax[0] + (jnp.arange(ng) + 0.5) * dxc
            y = yg[:, None]
            return _dmr_state(cfg, None, x, y, t)
        if kind is BC.DMACH2:
            # fixed post-shock wedge x<1/6 on the bottom wall, reflecting
            # beyond (reference: :100-160)
            assert cfg.ndim == 2 and axis == 0 and side == 0
            base = mirror(side, BC.REFLECTING)
            x = jnp.asarray(cfg.cell_centers(1))[None, None, :]
            post = jnp.asarray(np.array(
                list(DMR_POST) + [1.0] * cfg.ntracer))
            post = post.reshape((-1, 1, 1))
            return jnp.where(x < 1.0 / 6.0, post, base)
        if kind is BC.JET:
            # jet inflow within `radius` of the symmetry axis, reflecting
            # outside (reference: jet_boundaries.cpp); jet flows along +x,
            # so the face is the LAST axis lo side
            assert axis == cfg.ndim - 1 and side == 0
            assert bdata.jet is not None, "JET BC needs BoundaryData.jet"
            radius, jstate = bdata.jet
            base = mirror(side, BC.REFLECTING)
            if cfg.ndim == 2:
                # transverse axis 0 is already padded
                rr = jnp.abs(jnp.asarray(cfg.cell_centers(0, padded=True)))
                rdist = rr[None, :, None]
            else:
                yy = jnp.asarray(cfg.cell_centers(1, padded=True))
                zz = jnp.asarray(cfg.cell_centers(0, padded=True))
                yc = 0.5 * (cfg.xmin[1] + cfg.xmax[1])
                zc = 0.5 * (cfg.xmin[0] + cfg.xmax[0])
                rdist = jnp.hypot(zz[:, None] - zc, yy[None, :] - yc)
                rdist = rdist[None, :, :, None]
            js = jnp.asarray(jstate).reshape((-1,) + (1,) * cfg.ndim)
            return jnp.where(rdist < radius, js, base)
        raise NotImplementedError(f"BC {kind} not implemented yet")

    lo = ghost(0, lo_bc)
    hi = ghost(1, hi_bc)
    return jnp.concatenate([lo, P, hi], axis=ax)


def apply_bcs(P, cfg: SimConfig, bdata: Optional[BoundaryData] = None, t=0.0):
    """Pad all axes with BC-filled ghost zones (slowest axis first, so corner
    ghosts are filled from already-padded transverse data, matching the
    reference's sequential boundary updates)."""
    if bdata is None:
        bdata = BoundaryData()
    out = P
    for axis in range(cfg.ndim):
        out = _pad_axis(out, cfg, axis, bdata, t=t)
    return out


def make_fixed_strips(P0, cfg: SimConfig) -> BoundaryData:
    """Capture the initial edge states for INFLOW/FIXED faces
    (reference: inflow_boundaries.cpp BC_assign_INFLOW uses the IC edge
    value)."""
    ng = cfg.ng
    fixed = {}
    # Mimic apply_bcs' sequential padding: when axis a is padded, axes < a
    # are already padded and axes > a are not — strips must match that shape.
    out = np.asarray(P0)
    for axis in range(cfg.ndim):
        ax = 1 + axis
        n = out.shape[ax]
        lo = np.take(out, [0] * ng, axis=ax)
        hi = np.take(out, [n - 1] * ng, axis=ax)
        for side, kind in enumerate(cfg.bcs[axis]):
            if kind in (BC.INFLOW, BC.FIXED):
                fixed[(axis, side)] = (lo if side == 0 else hi).copy()
        out = np.concatenate([lo, out, hi], axis=ax)
    return BoundaryData(fixed=fixed)


def fill_ghost_side(padded, cfg: SimConfig, axis: int, side: int,
                    strip=None, t: float = 0.0):
    """Overwrite the ``ng`` ghost layers on ONE face of an already fully
    padded array with that face's domain BC, reading the adjacent interior
    layers.  Used by the nested-grid driver for fine-level faces that
    coincide with the root domain boundary (reference: setup_NG_grid
    assigns the simulation BC there, other faces get COARSE_TO_FINE —
    grid/setup_NG_grid.cpp:205-260).

    ``strip`` supplies the frozen ghost state for INFLOW/FIXED faces
    (full padded transverse shape).
    """
    ng = cfg.ng
    ax = 1 + axis
    kind = cfg.bcs[axis][side]
    k = cfg.ndim - 1 - axis
    n_tot = padded.shape[ax]

    def slab(lo, hi):
        idx = [slice(None)] * padded.ndim
        idx[ax] = slice(lo, hi)
        return padded[tuple(idx)]

    if kind in (BC.REFLECTING, BC.JETREFLECT, BC.AXISYMMETRIC):
        sg = jnp.asarray(_mirror_signs(cfg, axis, kind)).reshape(
            (-1,) + (1,) * cfg.ndim)
        src = slab(ng, 2 * ng) if side == 0 else slab(n_tot - 2 * ng,
                                                      n_tot - ng)
        val = jnp.flip(src, axis=ax) * sg
    elif kind in (BC.OUTFLOW, BC.ONEWAY_OUT):
        edge = slab(ng, ng + 1) if side == 0 else slab(n_tot - ng - 1,
                                                       n_tot - ng)
        val = jnp.broadcast_to(
            edge, edge.shape[:ax] + (ng,) + edge.shape[ax + 1:])
        if kind is BC.ONEWAY_OUT:
            vslot = VX + k
            vn = val[vslot]
            vn = jnp.minimum(vn, 0.0) if side == 0 else jnp.maximum(vn, 0.0)
            val = val.at[vslot].set(vn)
    elif kind in (BC.INFLOW, BC.FIXED):
        if strip is None:
            raise ValueError(f"{kind} on a refined level needs a frozen "
                             "ghost strip (captured at hierarchy setup)")
        val = jnp.asarray(strip)
    else:
        raise NotImplementedError(
            f"BC {kind} unsupported on a refined-level domain face")
    tgt = [slice(None)] * padded.ndim
    tgt[ax] = slice(0, ng) if side == 0 else slice(n_tot - ng, n_tot)
    return padded.at[tuple(tgt)].set(val)


def apply_bcs_outflow_only(P, cfg: SimConfig):
    """Pad every face with outflow ghosts (helper for strip capture)."""
    out = jnp.asarray(P)
    ng = cfg.ng
    for axis in range(cfg.ndim):
        ax = 1 + axis
        n = out.shape[ax]
        idx_lo = [slice(None)] * out.ndim
        idx_lo[ax] = slice(0, 1)
        idx_hi = [slice(None)] * out.ndim
        idx_hi[ax] = slice(n - 1, n)
        lo = out[tuple(idx_lo)]
        hi = out[tuple(idx_hi)]
        lo = jnp.broadcast_to(lo, lo.shape[:ax] + (ng,) + lo.shape[ax + 1:])
        hi = jnp.broadcast_to(hi, hi.shape[:ax] + (ng,) + hi.shape[ax + 1:])
        out = jnp.concatenate([lo, out, hi], axis=ax)
    return out
