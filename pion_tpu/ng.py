"""Static nested-grid (NG) refinement with Berger-Colella flux correction.

JAX re-derivation of the reference NG machinery
(reference: source/grid/setup_NG_grid.cpp:88-160 level extents about
NG_centre; source/sim_control/sim_control_NG.cpp:564-810 recursive
advance_step_OA1/OA2; source/boundaries/NG_coarse_to_fine_boundaries.cpp
slope-limited prolongation; NG_fine_to_coarse_boundaries.cpp:255-320
volume-weighted conserved restriction; NG_BC89flux.cpp Berger & Colella
1989 flux summation).

Structure: a stack of levels, each 2x finer with the SAME cell count,
nested about ``ng_centre`` (snapped to i/4 of the domain per axis, like
setup_NG_grid_levels), advanced depth-first with two fine steps per coarse
step.  Each level is a dense array + per-level geometry; C2F ghost filling
is a static-index gather + limited-slope prolongation, F2C is a
volume-weighted conservative average (exact in cylindrical/spherical
coords), and BC89 replaces the coarse flux at fine-boundary faces with the
area-weighted time-averaged sum of fine fluxes.  Fine-level faces that
coincide with the root domain boundary apply the domain BC instead of C2F
(reference: setup_NG_grid.cpp:205-260).  The level recursion is traced
into ONE jitted function (the 2:1 ratio makes the schedule static —
SURVEY.md §7).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .boundaries import (BoundaryData, apply_bcs, fill_ghost_side,
                         make_fixed_strips)
from .config import SimConfig
from .constants import BC, Coord, Eqn
from .device import HoistedJit
from .grid import Geometry, make_geometry
from .ops.eqns import cons_to_prim, prim_to_cons
from .ops.recon import van_albada
from .ops.sweep import dynamics_dU
from .ops.timestep import dynamics_dt
from .stepper import cell_advance, glm_psi_damp


def snap_ng_centre(cfg0: SimConfig) -> Tuple[float, ...]:
    """Snap the refinement centre to xmin + i/4 of the domain per axis so
    the oct-tree structure aligns with cell faces (reference:
    setup_NG_grid.cpp:93-112)."""
    out = []
    for ax in range(cfg0.ndim):
        lo, hi = cfg0.xmin[ax], cfg0.xmax[ax]
        rng = hi - lo
        c = cfg0.ng_centre[ax] if cfg0.ng_centre is not None else 0.5 * (lo + hi)
        f = 4.0 * (c - lo) / rng
        fr = f - np.floor(f)
        if not np.isclose(fr, 0.0, atol=1e-8) and not np.isclose(fr, 1.0,
                                                                 atol=1e-8):
            c = lo + np.round(f) * rng / 4.0
        out.append(float(np.clip(c, lo, hi)))
    return tuple(out)


def make_level_cfg(cfg0: SimConfig, level: int,
                   centre: Optional[Tuple[float, ...]] = None) -> SimConfig:
    """Level-l config: same cell counts, extents halved toward ``centre``
    per the reference recursion Xmin_l = (Xmin_{l-1} + centre)/2
    (reference: setup_NG_grid.cpp:142-155)."""
    if centre is None:
        centre = snap_ng_centre(cfg0)
    xmin = list(cfg0.xmin)
    xmax = list(cfg0.xmax)
    for _ in range(level):
        xmin = [0.5 * (lo + c) for lo, c in zip(xmin, centre)]
        xmax = [0.5 * (hi + c) for hi, c in zip(xmax, centre)]
    return cfg0.with_(xmin=tuple(xmin), xmax=tuple(xmax), nlevels=1,
                      ng_centre=None)


def _pairsum(a, axis):
    """Sum adjacent pairs along ``axis`` (length n -> n//2).

    In-place reshape (row-major split of the axis) instead of moveaxis:
    a moveaxis is a full-array transpose, the split-reshape is free."""
    axis = axis % a.ndim
    sh = a.shape
    a = a.reshape(sh[:axis] + (sh[axis] // 2, 2) + sh[axis + 1:])
    return a.sum(axis=axis + 1)


def _clamped_slice(A, axis, start, count):
    """Edge-clamped window [start, start+count) along ``axis``."""
    n = A.shape[axis]
    lo_pad = max(0, -start)
    hi_pad = max(0, start + count - n)
    core = jax.lax.slice_in_dim(A, start + lo_pad, start + count - hi_pad,
                                axis=axis)
    if not lo_pad and not hi_pad:
        return core
    parts = []
    if lo_pad:
        parts.extend([jax.lax.slice_in_dim(A, 0, 1, axis=axis)] * lo_pad)
    parts.append(core)
    if hi_pad:
        parts.extend([jax.lax.slice_in_dim(A, n - 1, n, axis=axis)]
                     * hi_pad)
    return jnp.concatenate(parts, axis=axis)


def _upsample2_clamped(A, axis, start, count):
    """``A`` windowed to ``count`` cells from ``start`` (edge-clamped) and
    each cell repeated twice along ``axis`` — the regular stride-2 gather
    pattern of C2F prolongation (indices clip(start+floor(i/2))) expressed
    as slice+repeat, which XLA lowers as broadcast/reshape instead of a
    gather."""
    n = A.shape[axis]
    lo_pad = max(0, -start)
    hi_pad = max(0, start + count - n)
    core = jax.lax.slice_in_dim(A, start + lo_pad, start + count - hi_pad,
                                axis=axis)
    parts = []
    if lo_pad:
        edge = jax.lax.slice_in_dim(A, 0, 1, axis=axis)
        parts.extend([edge] * lo_pad)
    parts.append(core)
    if hi_pad:
        edge = jax.lax.slice_in_dim(A, n - 1, n, axis=axis)
        parts.extend([edge] * hi_pad)
    W = jnp.concatenate(parts, axis=axis) if len(parts) > 1 else core
    return jnp.repeat(W, 2, axis=axis)


class NGHierarchy:
    """Holds per-level state and advances the stack recursively."""

    def __init__(self, cfg0: SimConfig, n_levels: Optional[int] = None,
                 states: Optional[List[jnp.ndarray]] = None,
                 physics=None):
        if n_levels is None:
            n_levels = cfg0.nlevels
        from .utils import ensure_precision
        ensure_precision(cfg0)
        self.n_levels = n_levels
        self.cfg0 = cfg0
        self.centre = snap_ng_centre(cfg0)
        self.cfgs = [make_level_cfg(cfg0, l, self.centre)
                     for l in range(n_levels)]
        self.geoms = [make_geometry(c) for c in self.cfgs]

        # per-level child window in PARENT cell indices: level l>=1 covers
        # parent cells [offs[l][ax], offs[l][ax] + n//2) on each axis
        self.offs: List[Optional[Tuple[int, ...]]] = [None]
        # fine-level faces that coincide with the ROOT domain boundary get
        # the domain BC; all others get C2F prolongation ghosts
        self.dom_sides: List[List[Tuple[int, int]]] = [[]]
        for l in range(1, n_levels):
            cfg_c, cfg_f = self.cfgs[l - 1], self.cfgs[l]
            offs = []
            sides = []
            for ax in range(cfg0.ndim):
                n = cfg0.shape[ax]
                off_f = (cfg_f.xmin[ax] - cfg_c.xmin[ax]) / cfg_c.dx
                off = int(round(off_f))
                assert abs(off_f - off) < 1e-6, (
                    f"level {l} axis {ax}: refinement window not cell-"
                    f"aligned (offset {off_f} parent cells; NG_centre must "
                    f"sit at i/4 of the domain and N must divide by 8 for "
                    f"odd i — reference setup_NG_grid.cpp:93-112)")
                assert 0 <= off and off + n // 2 <= n and n % 2 == 0
                offs.append(off)
                if np.isclose(cfg_f.xmin[ax], cfg0.xmin[ax]):
                    sides.append((ax, 0))
                if np.isclose(cfg_f.xmax[ax], cfg0.xmax[ax]):
                    sides.append((ax, 1))
            self.offs.append(tuple(offs))
            self.dom_sides.append(sides)

        self.physics = physics
        if physics is not None:
            # one Physics clone per level: same chemistry/sources, per-level
            # tracer geometry + wind masks (reference: sim_control_NG.cpp:138
            # setup_raytracing per level; RT_all_sources_levels :945-1011)
            self.phys = [physics.for_level(self.cfgs[l], self.geoms[l])
                         for l in range(n_levels)]
            for p in (physics.sources or []):
                if not p.at_infinity:
                    fine = self.cfgs[-1]
                    inside = all(fine.xmin[a] <= p.position[a] <= fine.xmax[a]
                                 for a in range(fine.ndim))
                    assert inside, (
                        "point radiation sources must lie inside the finest "
                        "level (reference production configs do; off-grid "
                        "point-source tracing is do_offgrid_raytracing, "
                        "disabled upstream too: sim_control_NG.cpp:959-969)")
        else:
            self.phys = [None] * n_levels
        self.t = 0.0
        self.step_count = 0
        self.last_dt = 0.0
        self._jit_cache = {}
        if states is not None:
            self.set_states(states)
        else:
            self.P = [None] * n_levels
            self.bdata = None
        # output policy (mirrors Simulation; reference: sim_init.cpp:671-760)
        self.outfile: Optional[str] = None
        self.opfreq = 0
        self.opfreq_time = 0.0
        self.checkpoint_freq = 0
        self.log_freq = 0
        self.params: Optional[dict] = None
        self._ckpt_flip = 0
        self._writer = None
        self._next_optime = None

    def set_states(self, states):
        # normalize to the config dtype (see Simulation.__post_init__:
        # arrays made before the x64 flip would mix dtypes in-graph)
        self.P = [jnp.asarray(s, dtype=self.cfg0.np_dtype) for s in states]
        from .parallel.mesh import mesh_requested

        if mesh_requested(self.cfg0) and self.cfg0.halo != "explicit":
            # every level shares one spatial device mesh (reference:
            # per-level MCMD decomposition over ALL ranks, sim_params.h:189)
            from .parallel.mesh import make_mesh, shard_state

            self.mesh = make_mesh(self.cfg0)
            self.P = [shard_state(p, self.mesh, self.cfg0) for p in self.P]
        self.bdata = make_fixed_strips(np.asarray(self.P[0]), self.cfgs[0])
        # frozen INFLOW/FIXED ghost strips for fine-level domain faces
        # (full padded transverse shape, captured from the initial state by
        # edge replication — reference: BC_assign_INFLOW uses IC edge data)
        self.level_strips: List[Dict[Tuple[int, int], np.ndarray]] = [{}]
        for l in range(1, self.n_levels):
            cfg = self.cfgs[l]
            strips = {}
            need = [(ax, sd) for (ax, sd) in self.dom_sides[l]
                    if cfg.bcs[ax][sd] in (BC.INFLOW, BC.FIXED)]
            if need:
                from .boundaries import apply_bcs_outflow_only

                pad = np.asarray(apply_bcs_outflow_only(
                    jnp.asarray(self.P[l]), cfg))
                ng = cfg.ng
                for ax, sd in need:
                    a = 1 + ax
                    idx = [slice(None)] * pad.ndim
                    idx[a] = slice(0, ng) if sd == 0 else slice(
                        pad.shape[a] - ng, pad.shape[a])
                    strips[(ax, sd)] = pad[tuple(idx)].copy()
            self.level_strips.append(strips)
        for l in range(self.n_levels):
            if self.phys[l] is not None and self.phys[l].winds:
                self.P[l] = self.phys[l].apply_internal_bcs(self.P[l], self.t)
        self._jit_cache = {}

    # -- C2F prolongation --------------------------------------------------
    def _prolong_padded(self, Pc, level: int):
        """Fill the fine level's padded array from the parent: each fine
        cell (incl. ghosts) takes parent value + limited slope * offset
        (reference: NG_coarse_to_fine_boundaries.cpp:406-578
        interpolate_coarse2fine with AvgFalle slopes)."""
        cfg_f = self.cfgs[level]
        nd = cfg_f.ndim
        ng = cfg_f.ng
        assert ng == 2, "stride-2 upsample pattern assumes ghost depth 2"
        off = self.offs[level]
        # parent index of each fine padded cell per axis: fine cell i_f
        # (counted from the child's xmin) sits in parent off + i_f//2 —
        # a regular pattern: parent window [off-1, off+n/2] edge-clamped,
        # each cell used twice (see _upsample2_clamped)
        offs = []
        starts = []
        counts = []
        for ax in range(nd):
            n = cfg_f.shape[ax]
            i_f = np.arange(-ng, n + ng)
            o = np.where(i_f % 2 == 0, -0.25, +0.25)  # units of parent dx
            offs.append(jnp.asarray(o.astype(cfg_f.np_dtype)))
            starts.append(off[ax] - 1)
            counts.append(n // 2 + ng)

        def upsample_all(A):
            for ax in range(nd):
                A = _upsample2_clamped(A, 1 + ax, starts[ax], counts[ax])
            return A

        total = upsample_all(Pc)
        for ax in range(nd):
            a = 1 + ax
            lo = jax.lax.slice_in_dim(Pc, 0, 1, axis=a)
            hi = jax.lax.slice_in_dim(Pc, Pc.shape[a] - 1, Pc.shape[a],
                                      axis=a)
            ppad = jnp.concatenate([lo, Pc, hi], axis=a)
            d = jnp.diff(ppad, axis=a)
            sl = van_albada(
                jax.lax.slice_in_dim(d, 0, d.shape[a] - 1, axis=a),
                jax.lax.slice_in_dim(d, 1, d.shape[a], axis=a),
            )
            sl = upsample_all(sl)
            shape = [1] * (nd + 1)
            shape[a] = len(offs[ax])
            total = total + sl * offs[ax].reshape(shape)
        return total

    def _prolong_window(self, Pc, level: int, franges):
        """Prolongated fine-padded values for the box given by per-axis
        fine ranges ``(fstart, fcount)`` in fine-padded coordinates
        i_f in [-ng, n+ng) (both even).  Identical values to the
        corresponding window of :meth:`_prolong_padded`, at window cost —
        the full-cube prolongation computes fine interior values that are
        immediately overwritten by the level's own state; the ghost shells
        are ~1/20 of the volume."""
        cfg_f = self.cfgs[level]
        nd = cfg_f.ndim
        off = self.offs[level]
        ps, pc, offvecs = [], [], []
        for ax, (fs, fcnt) in enumerate(franges):
            assert fs % 2 == 0 and fcnt % 2 == 0
            ps.append(off[ax] + fs // 2)
            pc.append(fcnt // 2)
            i_f = np.arange(fs, fs + fcnt)
            o = np.where(i_f % 2 == 0, -0.25, +0.25)
            offvecs.append(jnp.asarray(o.astype(cfg_f.np_dtype)))

        def up_all(A):
            for ax in range(nd):
                A = _upsample2_clamped(A, 1 + ax, ps[ax], pc[ax])
            return A

        total = up_all(Pc)
        for ax in range(nd):
            a = 1 + ax
            # limited slope at the parent rows of this window (one-row
            # margins, edge-clamped like the full-parent version)
            marg = _clamped_slice(Pc, a, ps[ax] - 1, pc[ax] + 2)
            d = jnp.diff(marg, axis=a)
            sl = van_albada(
                jax.lax.slice_in_dim(d, 0, d.shape[a] - 1, axis=a),
                jax.lax.slice_in_dim(d, 1, d.shape[a], axis=a),
            )
            sl = jnp.repeat(sl, 2, axis=a)
            for bx in range(nd):
                if bx != ax:
                    sl = _upsample2_clamped(sl, 1 + bx, ps[bx], pc[bx])
            shape = [1] * (nd + 1)
            shape[a] = len(offvecs[ax])
            total = total + sl * offvecs[ax].reshape(shape)
        return total

    def _pad_level(self, level: int, Ph, parent_state):
        """Padded state for level: domain BCs at level 0; C2F ghosts from
        the parent otherwise, except on faces coinciding with the root
        domain boundary, which apply the domain BC."""
        cfg = self.cfgs[level]
        if level == 0:
            return apply_bcs(Ph, cfg, self.bdata)
        ng = cfg.ng
        nd = cfg.ndim
        n = cfg.shape
        # ghost slabs only (nested concat; corners come from the first
        # axis's full-transverse slabs, identical to the full prolongation)
        padded = Ph
        for ax in range(nd - 1, -1, -1):
            franges = []
            for bx in range(nd):
                if bx < ax:
                    franges.append((0, n[bx]))
                elif bx == ax:
                    franges.append(None)  # placeholder
                else:
                    franges.append((-ng, n[bx] + 2 * ng))
            fr_lo = list(franges)
            fr_lo[ax] = (-ng, ng)
            fr_hi = list(franges)
            fr_hi[ax] = (n[ax], ng)
            lo = self._prolong_window(parent_state, level, fr_lo)
            hi = self._prolong_window(parent_state, level, fr_hi)
            padded = jnp.concatenate([lo, padded, hi], axis=1 + ax)
        for ax, sd in self.dom_sides[level]:
            padded = fill_ghost_side(
                padded, cfg, ax, sd,
                strip=self.level_strips[level].get((ax, sd)))
        return padded

    # -- F2C restriction ---------------------------------------------------
    def _restrict(self, Pc, Pf, level_f: int):
        """Replace covered coarse cells with the VOLUME-WEIGHTED
        conserved-variable average of their 2^ndim children (reference:
        NG_fine_to_coarse_boundaries.cpp:255-320 average_cells —
        sum(U*vol)/sum(vol); exact for cylindrical/spherical metrics)."""
        cfg_f = self.cfgs[level_f]
        cfg_c = self.cfgs[level_f - 1]
        nd = cfg_f.ndim
        off = self.offs[level_f]
        Uf = prim_to_cons(Pf, cfg_f)
        # relative volume weights: absolute cgs volumes overflow float32
        v64 = np.asarray(self.geoms[level_f].cell_volume, dtype=np.float64)
        Vf = jnp.asarray((v64 / v64.max()).astype(cfg_f.np_dtype))
        W = Uf * Vf
        V = jnp.broadcast_to(Vf, Uf.shape[1:])
        for ax in range(nd):
            W = _pairsum(W, 1 + ax)
            V = _pairsum(V, ax)
        Uc_win = W / V
        # window-only conversion: uncovered coarse cells stay bitwise
        # untouched (a full-grid prim->cons->prim round trip would add fp
        # noise outside the window)
        P_win = cons_to_prim(Uc_win, cfg_c)
        sl = (slice(None),) + tuple(
            slice(off[ax], off[ax] + cfg_c.shape[ax] // 2)
            for ax in range(nd))
        return Pc.at[sl].set(P_win)

    # -- BC89 flux correction ----------------------------------------------
    def _face_weights(self, level: int, ax: int) -> Dict[int, np.ndarray]:
        """Per-transverse-axis area weight vectors for faces normal to
        ``ax`` (reference: face areas VectorOps.cpp:688-697).  Cartesian:
        uniform.  Cylindrical z-faces: area per R-row proportional to
        R_centre (pi*((R+)^2-(R-)^2) = 2 pi R dR)."""
        cfg = self.cfgs[level]
        out = {}
        for bx in range(cfg.ndim):
            if bx == ax:
                continue
            g = self.geoms[level].axes[bx]
            if g.is_radial and cfg.coords is Coord.CYLINDRICAL:
                ng = cfg.ng
                out[bx] = np.asarray(
                    g.pos[ng: ng + cfg.shape[bx]], dtype=cfg.np_dtype)
            else:
                out[bx] = np.ones(cfg.shape[bx], dtype=cfg.np_dtype)
        return out

    def _restrict_face_flux(self, Ff, ax, level_f: int):
        """Area-weighted average of the fine boundary-plane flux onto
        coarse faces: 2^(nd-1) fine faces per coarse face (reference:
        NG_BC89flux.cpp recv_BC89_fluxes_F2C sums F*dA / sum dA)."""
        cfg_f = self.cfgs[level_f]
        nd = cfg_f.ndim
        wv = self._face_weights(level_f, ax)
        out = Ff
        # Ff: (nvar, ...transverse...) with the sweep axis removed
        k = 0
        for bx in range(nd):
            if bx == ax:
                continue
            a = 1 + k
            w = jnp.asarray(wv[bx]).reshape(
                (1,) * a + (-1,) + (1,) * (out.ndim - a - 1))
            num = _pairsum(out * w, a)
            den = _pairsum(jnp.broadcast_to(w, (1,) + out.shape[1:]), a)
            out = num / den
            k += 1
        return out

    def _bc89_correct(self, dU, get_face, fine_face_sums, level: int, dt):
        """Adjust the dU of coarse cells just outside the fine grid so the
        interface flux equals the time-averaged fine flux (Berger & Colella
        1989; reference: NG_BC89flux.cpp recv_BC89_fluxes_F2C).  Skipped on
        faces where the child touches the domain boundary (no outside
        cell).  ``get_face(ax, i)`` returns the full transverse interface
        plane at index i of axis ax."""
        cfg = self.cfgs[level]
        nd = cfg.ndim
        off_c = self.offs[level + 1]
        for ax in range(nd):
            n = cfg.shape[ax]
            lo_i = off_c[ax]               # coarse interface index, low side
            hi_i = off_c[ax] + n // 2      # high side
            Ff_lo, Ff_hi = fine_face_sums[ax]   # restricted fine fluxes
            g = self.geoms[level].axes[ax]
            cn = jnp.asarray(g.div_cn)
            cp = jnp.asarray(g.div_cp)

            # full-rank index helper: transverse window covered by the fine
            # grid, position i on the sweep axis
            def widx(i):
                sl = [slice(None)]
                for bx in range(nd):
                    if bx == ax:
                        sl.append(i)
                    else:
                        sl.append(slice(off_c[bx],
                                        off_c[bx] + cfg.shape[bx] // 2))
                return tuple(sl)

            def wplane(plane):
                # window a full transverse interface plane to the child
                sl = [slice(None)]
                for bx in range(nd):
                    if bx == ax:
                        continue
                    sl.append(slice(off_c[bx],
                                    off_c[bx] + cfg.shape[bx] // 2))
                return plane[tuple(sl)]

            # the coarse cell OUTSIDE the low interface is lo_i-1 (its HIGH
            # face, coefficient cp): dudt = cn*f_lo - cp*f_hi, so swapping
            # the coarse flux for the fine one adds cp*(F_coarse - F_fine).
            # At the high interface the outside cell is hi_i and its LOW
            # face gets the opposite sign.
            if lo_i > 0:
                corr_lo = wplane(get_face(ax, lo_i)) - Ff_lo
                dU = dU.at[widx(lo_i - 1)].add(dt * cp[lo_i - 1] * corr_lo)
            if hi_i < n:
                corr_hi = wplane(get_face(ax, hi_i)) - Ff_hi
                dU = dU.at[widx(hi_i)].add(-dt * cn[hi_i] * corr_hi)
        return dU

    # -- per-level radiation columns ----------------------------------------
    def _child_tau_offsets(self, level: int, Ph, tau_in):
        """Entry-column offsets for level+1's sources-at-infinity: this
        level's tau field sliced at the child's upstream boundary plane,
        windowed to the child's transverse footprint and prolonged 2x
        (the dense-array equivalent of the reference's C2F boundary Tau data,
        NG_coarse_to_fine_boundaries.cpp + cell extra_data columns).
        Point sources need no offset: production configs keep them inside
        every level."""
        phys = self.phys[level]
        if phys is None or not phys.sources:
            return None
        inf_idx = [i for i, s in enumerate(phys.sources) if s.at_infinity]
        if not inf_idx:
            return None
        taus = phys.trace_taus(Ph, tau_in)
        cfg = self.cfgs[level]
        nd = cfg.ndim
        off_c = self.offs[level + 1]
        out = {}
        for i in inf_idx:
            s = phys.sources[i]
            ax = s.axis
            idx = (off_c[ax] if s.sign > 0
                   else off_c[ax] + cfg.shape[ax] // 2 - 1)
            plane = jnp.take(taus[i], idx, axis=ax)  # (transverse parent)
            # window to the child's footprint then prolong 2x per axis
            k = 0
            for bx in range(nd):
                if bx == ax:
                    continue
                plane = jax.lax.slice_in_dim(
                    plane, off_c[bx], off_c[bx] + cfg.shape[bx] // 2, axis=k)
                plane = jnp.repeat(plane, 2, axis=k)
                k += 1
            out[i] = jnp.expand_dims(plane, ax)  # broadcasts along the ray
        return out

    # -- time stepping -----------------------------------------------------
    def _dt_fn(self):
        """All-level dt as ONE jitted reduction -> single host sync
        (reference policy: sim_control_NG.cpp:288-341 coarse dt = 2^l *
        finest-limited dt; chemistry limit per calc_timestep.cpp:342)."""
        if "dt" not in self._jit_cache:
            def whole(states, sp=None):
                vals = []
                for l in range(self.n_levels):
                    ph_l = self.phys[l]
                    excl = (ph_l.wind_exclude_mask()
                            if ph_l is not None and ph_l.winds else None)
                    d = dynamics_dt(states[l], self.cfgs[l], self.geoms[l],
                                    exclude=excl)
                    phys = self.phys[l]
                    if (phys is not None and phys.dt_limit
                            and phys.mp is not None):
                        d = jnp.minimum(
                            d, phys.timescale(states[l], self.cfgs[l],
                                              sp=sp))
                    vals.append(d * (2 ** l))
                return jnp.min(jnp.stack(vals))

            self._jit_cache["dt"] = HoistedJit(whole)
        return self._jit_cache["dt"]

    def compute_dt(self, sp=None) -> float:
        dt0 = float(self._dt_fn()(tuple(self.P), sp))
        if self.last_dt > 0.0:
            dt0 = min(dt0, self.cfgs[0].max_dt_growth * self.last_dt)
        return dt0

    def _advance_level(self, level: int, dt, parent_state=None,
                       tau_in=None, t0=None, states=None, sp=None,
                       rt0_map=None):
        """One OA2 step of `level` with two recursive substeps of level+1.
        Returns the time-summed restricted boundary-plane fluxes for the
        parent's BC89 correction (reference: sim_control_NG.cpp:679-810).
        ``tau_in``: per-source upstream column offsets handed down by the
        parent (sources at infinity only).  ``states``: mutable list the
        recursion reads/writes (traced values under jit); defaults to
        ``self.P`` for the eager path."""
        if states is None:
            states = self.P
        cfg = self.cfgs[level]
        geom = self.geoms[level]
        phys = self.phys[level]
        P = states[level]
        from .stepper import _scma_flag

        scma = _scma_flag(phys)
        glm = cfg.eqn is Eqn.GLM
        ch = cfg.cfl * geom.dx / dt if glm else None
        if t0 is None:
            t0 = self.t

        # predictor half-step (1st-order space)
        Ppad = self._pad_level(level, P, parent_state)
        dU_h, _ = dynamics_dU(Ppad, cfg, geom, 0.5 * dt, 1, ch=ch, scma=scma)
        if phys is not None and phys.mp is not None:
            # reuse the columns traced through this pre-step state by the
            # fused dt computation, when available (first touch per level)
            rt_pre = (rt0_map or {}).get(level)
            dU_h = dU_h + phys.mp_delta_U(P, P, 0.5 * dt, cfg, tau_in,
                                          sp=sp, rt=rt_pre)
        Ph = cell_advance(P, dU_h, cfg)
        if glm:
            Ph = glm_psi_damp(Ph, 0.5 * dt, ch, cfg, geom)
        if phys is not None and phys.winds:
            Ph = phys.apply_internal_bcs(Ph, t0 + 0.5 * dt)

        # columns handed to the child (lagged by a half step, like the
        # reference's boundary-data Tau: RT runs before the C2F send,
        # sim_control_NG.cpp:653-656)
        tau_child = (self._child_tau_offsets(level, Ph, tau_in)
                     if level + 1 < self.n_levels else None)

        # first fine substep (C2F ghosts frozen at this level's Ph)
        fine_sums_1 = None
        if level + 1 < self.n_levels:
            fine_sums_1 = self._advance_level(level + 1, 0.5 * dt, Ph,
                                              tau_child, t0, states, sp,
                                              rt0_map)

        # corrector (2nd-order space); the sweep's face arrays feed BC89
        # and the boundary restriction
        Ppad = self._pad_level(level, Ph, parent_state)
        dU_f, faces = dynamics_dU(Ppad, cfg, geom, dt, 2, ch=ch, scma=scma)

        def get_face(ax_, i_):
            return jnp.take(faces[ax_], i_, axis=1 + ax_)
        if phys is not None and phys.mp is not None:
            dU_f = dU_f + phys.mp_delta_U(P, Ph, dt, cfg, tau_in,
                                          sp=sp)

        # second fine substep
        fine_sums_2 = None
        if level + 1 < self.n_levels:
            fine_sums_2 = self._advance_level(level + 1, 0.5 * dt, Ph,
                                              tau_child, t0 + 0.5 * dt,
                                              states, sp)

        # BC89: correct this level's dU with the fine fluxes
        if level + 1 < self.n_levels:
            sums = []
            for ax in range(cfg.ndim):
                lo = 0.5 * (fine_sums_1[ax][0] + fine_sums_2[ax][0])
                hi = 0.5 * (fine_sums_1[ax][1] + fine_sums_2[ax][1])
                sums.append((lo, hi))
            dU_f = self._bc89_correct(dU_f, get_face, sums, level, dt)

        P_new = cell_advance(P, dU_f, cfg)
        if glm:
            P_new = glm_psi_damp(P_new, dt, ch, cfg, geom)
        if phys is not None and phys.mp is not None:
            # temperature ceiling (reference: grid_update_state_vector
            # clamps, time_integrator.cpp:881-940)
            T = phys.mp.temperature(P_new, cfg)
            P_new = jnp.where(T > cfg.max_temperature,
                              phys.mp.set_temp(P_new, cfg.max_temperature,
                                               cfg), P_new)
        if phys is not None and phys.winds:
            P_new = phys.apply_internal_bcs(P_new, t0 + dt)

        # F2C restriction
        if level + 1 < self.n_levels:
            P_new = self._restrict(P_new, states[level + 1], level + 1)
        states[level] = P_new

        # boundary-plane fluxes of this level, restricted to parent faces
        if level == 0:
            return None
        out = []
        for ax in range(cfg.ndim):
            lo = self._restrict_face_flux(get_face(ax, 0), ax, level)
            hi = self._restrict_face_flux(get_face(ax, cfg.shape[ax]), ax,
                                          level)
            out.append((lo, hi))
        return out

    def _step_fn(self):
        """The whole level recursion jitted as ONE pure function
        (states, dt, t) -> states: the fixed 2:1 subcycling unrolls at trace
        time, so XLA sees a single static program per step (SURVEY.md §7:
        'unroll the level recursion over per-level jitted steps' — fusing
        the full recursion beats per-level jit by removing every host
        round-trip between substeps)."""
        if "step" not in self._jit_cache:
            def whole(states, dt, t, sp=None):
                st = list(states)
                self._advance_level(0, dt, t0=t, states=st, sp=sp)
                return tuple(st)

            self._jit_cache["step"] = HoistedJit(whole)
        return self._jit_cache["step"]

    def _fused_step_fn(self):
        """dt + full hierarchy step in ONE compiled program: the per-level
        dt limits, growth clamp and end/output-time cap run in-graph, and
        the radiation columns traced for the chemistry dt limit are reused
        by each level's first predictor (the reference also raytraces once
        per partial update — time_integrator.cpp:206-243; dt policy per
        calc_timestep.cpp:219-260 with the coarse dt slaved to the finest,
        sim_control_NG.cpp:288-341)."""
        if "fused" not in self._jit_cache:
            def whole(states, t, last_dt, dt_cap, sp=None):
                rt0_map = {}
                vals = []
                for l in range(self.n_levels):
                    ph_l = self.phys[l]
                    excl = (ph_l.wind_exclude_mask()
                            if ph_l is not None and ph_l.winds else None)
                    d = dynamics_dt(states[l], self.cfgs[l], self.geoms[l],
                                    exclude=excl)
                    phys = self.phys[l]
                    if (phys is not None and phys.dt_limit
                            and phys.mp is not None):
                        r = None
                        if phys.sources and not any(
                                s.at_infinity for s in phys.sources):
                            # point-source columns need no parent tau
                            # offsets: trace once, reuse in the predictor
                            r = phys.raytrace(states[l], sp=sp)
                        if r is not None:
                            rt0_map[l] = r
                        d = jnp.minimum(
                            d, phys.timescale(states[l], self.cfgs[l],
                                              rt=r, sp=sp))
                    vals.append(d * (2 ** l))
                dt = jnp.min(jnp.stack(vals))
                dt = jnp.where(last_dt > 0.0,
                               jnp.minimum(dt, self.cfgs[0].max_dt_growth
                                           * last_dt), dt)
                dt = jnp.minimum(dt, dt_cap)
                st = list(states)
                self._advance_level(0, dt, t0=t, states=st, sp=sp,
                                    rt0_map=rt0_map)
                return tuple(st), dt

            self._jit_cache["fused_raw"] = whole
            self._jit_cache["fused"] = HoistedJit(whole)
        return self._jit_cache["fused"]

    def _multi_step_fn(self, K: int):
        """K fused hierarchy steps in ONE compiled dispatch (lax.scan),
        amortising the per-dispatch host latency that NG production runs
        otherwise pay once per hierarchy step.  Once t reaches the
        target the in-graph dt clamps to 0 and states pass through."""
        key = ("multi", K)
        if key not in self._jit_cache:
            self._fused_step_fn()
            whole = self._jit_cache["fused_raw"]

            def runK(states, t, last_dt, t_target, sp=None):
                def body(carry, _):
                    st, tc, ldt = carry
                    cap = t_target - tc
                    live = cap > 0.0
                    st2, dt = whole(st, tc, ldt,
                                    jnp.where(live, cap, 1.0), sp)
                    dt_eff = jnp.where(live, dt, 0.0)
                    stn = tuple(jnp.where(live, a, b)
                                for a, b in zip(st2, st))
                    return ((stn, tc + dt_eff,
                             jnp.where(live, dt, ldt)), dt_eff)

                (stn, tn, ldtn), dts = jax.lax.scan(
                    body, (tuple(states), t, last_dt), None, length=K)
                return stn, dts

            self._jit_cache[key] = HoistedJit(runK)
        return self._jit_cache[key]

    def _dt_cap(self) -> float:
        """End-time / next-timed-output ceiling (reference:
        timestep_checking_and_limiting, calc_timestep.cpp:243-252)."""
        tmax = getattr(self, "_tmax", None) or self.cfgs[0].tmax
        cap = tmax - self.t
        # first-step wind-speed ceiling, scaled from the finest level to
        # the root dt (reference: calc_dynamics_dt timestep-0 wind cap)
        if (self.step_count == 0 and self.physics is not None
                and self.physics.wind_sources):
            fine = self.n_levels - 1
            cap = min(cap, self.phys[fine].wind_dt_cap(self.cfgs[fine],
                                                       self.geoms[fine])
                      * 2 ** fine)
        if self.opfreq_time > 0.0 and self.outfile is not None:
            nxt = self._next_optime
            if nxt is None:
                nxt = self.t + self.opfreq_time
            to_next = nxt - self.t
            tol = 1.0e-12 * max(abs(nxt), self.opfreq_time)
            if to_next <= tol:
                to_next += self.opfreq_time
            cap = min(cap, to_next)
        return max(cap, 0.0)

    def step(self, dt: float = None) -> float:
        sp = (self.physics.update_sources(self.t)
              if self.physics is not None and self.physics.sources else None)
        if dt is None:
            states, dtv = self._fused_step_fn()(
                tuple(self.P), self.t, self.last_dt, self._dt_cap(), sp)
            self.P = list(states)
            dt = float(dtv)
        else:
            self.P = list(self._step_fn()(tuple(self.P), dt, self.t, sp))
        self.t += dt
        self.last_dt = dt
        self.step_count += 1
        return dt

    # -- snapshots / restart (reference: every snapshot is a full restart
    # file with one mesh per level, dataIO/dataio_silo.h:67) ---------------
    def _stacked_state(self) -> np.ndarray:
        return np.stack([np.asarray(p) for p in self.P])

    def _header_cfg(self) -> SimConfig:
        return self.cfg0.with_(nlevels=self.n_levels, ng_centre=self.centre)

    def save(self, path: Optional[str] = None, wait: bool = True) -> str:
        if path is None:
            assert self.outfile, "set NGHierarchy.outfile or pass a path"
            path = f"{self.outfile}.{self.step_count:08d}"
        extra = {"params": self.params} if self.params else None
        if wait:
            from .io import save_snapshot

            self.flush_io()
            return save_snapshot(path, self._stacked_state(),
                                 self._header_cfg(), self.t, self.step_count,
                                 extra=extra)
        if self._writer is None:
            from .io.snapshot import AsyncSnapshotWriter

            self._writer = AsyncSnapshotWriter()
        self._writer.submit(path, self._stacked_state(), self._header_cfg(),
                            self.t, self.step_count, extra)
        return path

    def flush_io(self):
        if self._writer is not None:
            self._writer.wait()

    @classmethod
    def restart(cls, path: str, physics=None, **kw) -> "NGHierarchy":
        """Resume from a multi-level snapshot.  If the snapshot header
        carries the original parameter section and no ``physics`` is given,
        the full Physics (chemistry/RT/winds) is rebuilt from it
        (reference: sim_init.cpp:173-321 rebuilds MP/RT/winds from the
        header registry)."""
        from .io.snapshot import load_snapshot_raw

        cfg, P, t, step, extra = load_snapshot_raw(path)
        params = (extra or {}).get("params")
        if physics is None and params:
            from .cli import jet_from_params, physics_from_params

            physics = physics_from_params(cfg, params)
        hier = cls(cfg, physics=physics, **kw)
        hier.t = t
        hier.step_count = step
        hier.params = params
        hier.set_states([jnp.asarray(p) for p in P])
        return hier

    def _maybe_output(self):
        if self.outfile is None:
            return
        if self.opfreq and self.step_count % self.opfreq == 0:
            self.save(wait=False)
        if self.opfreq_time > 0.0:
            if self._next_optime is None:
                self._next_optime = self.t + self.opfreq_time
            if self.t >= self._next_optime:
                while self._next_optime <= self.t:
                    self._next_optime += self.opfreq_time
                self.save(wait=False)
        if self.checkpoint_freq and \
                self.step_count % self.checkpoint_freq == 0:
            suffix = 999999 - self._ckpt_flip
            self._ckpt_flip ^= 1
            self.save(f"{self.outfile}.{suffix}", wait=False)

    def run(self, tmax: Optional[float] = None, max_steps: int = 10**9,
            chunk: int = 1):
        """Advance to ``tmax``.  ``chunk`` > 1 batches that many fused
        hierarchy steps into one dispatch (see _multi_step_fn); engages
        only when no host work (timed outputs / fine logging) must run
        between steps — same contract as Simulation.run."""
        from .utils import StepLogger

        tmax = self.cfgs[0].tmax if tmax is None else tmax
        self._tmax = tmax
        logger = StepLogger(self.log_freq)
        can_chunk = (chunk > 1 and self.opfreq_time == 0.0
                     and self.opfreq % chunk == 0
                     and self.checkpoint_freq % chunk == 0
                     and (self.log_freq == 0 or self.log_freq % chunk == 0))
        while self.t < tmax * (1 - 1e-12) and self.step_count < max_steps:
            if (can_chunk and self.step_count + chunk <= max_steps
                    and not (self.step_count == 0
                             and self.physics is not None
                             and self.physics.wind_sources)):
                sp = (self.physics.update_sources(self.t)
                      if self.physics is not None and self.physics.sources
                      else None)
                states, dts = self._multi_step_fn(chunk)(
                    tuple(self.P), self.t, self.last_dt, tmax, sp)
                dts = np.asarray(dts)
                live = int((dts > 0).sum())
                if live == 0:
                    break
                self.P = list(states)
                self.t += float(dts.sum())
                self.last_dt = float(dts[live - 1])
                self.step_count += live
                dt = float(dts[live - 1])
                self._maybe_output()
                logger.log(self.step_count, self.t, dt, self.P[0])
                continue
            # fused dt+advance (dt capped in-graph to tmax / output times)
            dt = self.step()
            self._maybe_output()
            logger.log(self.step_count, self.t, dt, self.P[0])
        if self.outfile is not None:
            self.save()
        self.flush_io()
        return self
