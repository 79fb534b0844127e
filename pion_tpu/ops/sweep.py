"""Directionally-unsplit finite-volume flux sweeps.

This is the dense-array replacement for the reference's per-column pointer walk
(reference: source/sim_control/time_integrator.cpp:498-860
``calc_dynamics_dU`` -> ``dynamics_dU_column``, and
source/spatial_solvers/solver_eqn_base.cpp:152-204 ``InterCellFlux``):
instead of marching cell-by-cell down columns, every axis is processed as one
whole-array shifted-slice computation — slopes, edge states, Riemann fluxes
and source terms are all dense elementwise ops that XLA fuses, with the
fast (contiguous) dimension riding the innermost grid axis.

Per-axis work uses shifted SLICES; for a non-minor sweep axis one explicit
transpose puts that axis last (see ``dynamics_dU``).

``dynamics_dU`` returns the *accumulated conserved increment* dt*(-div F + S)
for interior cells, plus the per-axis face fluxes (for Berger-Colella 1989
flux correction between refinement levels), with each flux array keeping the
sweep axis in its natural position (length n+1 there).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import jax.numpy as jnp

from ..config import SimConfig
from ..constants import BX, BY, BZ, PG, RO, SI, VX, VY, VZ, AV, Coord, Eqn, Solver
from ..grid import Geometry
from . import riemann_hydro as rh
from . import riemann_mhd as rm
from .eqns import (
    cfast_components,
    cons_to_prim,
    inverse_perm,
    maxspeed,
    prim_to_cons,
    sweep_perm,
)
from .recon import van_albada


def _slab(A, ax: int, lo: int, hi: Optional[int]):
    """A[..., lo:hi, ...] along array axis ``ax`` (hi=None means to end;
    negative hi counts from the end)."""
    idx = [slice(None)] * A.ndim
    idx[ax] = slice(lo, hi)
    return A[tuple(idx)]


def _bcast(v, axis: int, ndim: int):
    """Reshape a 1D per-cell array so it broadcasts along spatial ``axis``
    of a (nvar, *spatial) array."""
    return jnp.asarray(v).reshape((1,) * (1 + axis) + (-1,) + (1,) * (ndim - 1 - axis))


def _scma_elements(Plt, Prt, Pl_r, Pr_r, el_slots, cfg: SimConfig):
    """Scale the element tracers of each edge state by 1/sum(clip(el,0,1))
    (reference: microphysics_base.cpp:96-118 sCMA element loop)."""
    def factor(P):
        ssum = None
        for e in el_slots:
            v = jnp.clip(P[e], 0.0, 1.0)
            ssum = v if ssum is None else ssum + v
        return 1.0 / jnp.maximum(ssum, 1.0e-30)

    fl = factor(Pl_r)
    fr = factor(Pr_r)
    base = cfg.eqn.nbase
    li = list(range(Plt.shape[0]))
    Plt = jnp.stack([Plt[i] * fl if (base + i) in el_slots else Plt[i]
                     for i in li])
    Prt = jnp.stack([Prt[i] * fr if (base + i) in el_slots else Prt[i]
                     for i in li])
    return Plt, Prt


def _interior(A: jnp.ndarray, cfg: SimConfig, skip_axis: Optional[int] = None):
    """Slice ghost zones off every spatial axis (except ``skip_axis``)."""
    ng = cfg.ng
    sl = [slice(None)]  # variable axis
    for ax in range(cfg.ndim):
        sl.append(slice(None) if ax == skip_axis else slice(ng, -ng))
    return A[tuple(sl)]


def _reconstruct(Pt, cfg: SimConfig, geom: Geometry, axis: int, order: int,
                 eff_axis: int = None):
    """Slopes + edge states along the sweep axis.

    ``Pt`` is padded along the sweep axis only; ``eff_axis`` is the axis's
    position in Pt's layout (the caller may have moved it last so XLA fuses
    the elementwise pipeline over a contiguous minor dimension).  Geometry
    is keyed by the logical ``axis``.  Returns (Pl, Pr, slope_c).
    """
    eff_axis = axis if eff_axis is None else eff_axis
    g = geom.axes[axis]
    ng = cfg.ng
    n = cfg.shape[axis]
    ax = 1 + eff_axis
    nd = cfg.ndim
    if order == 1:
        # Piecewise-constant (reference: VectorOps.cpp:587-589 with OA1)
        Pl = _slab(Pt, ax, ng - 1, ng + n)
        Pr = _slab(Pt, ax, ng, ng + n + 1)
        slope_c = jnp.zeros_like(_slab(Pt, ax, ng, ng + n))
        return Pl, Pr, slope_c
    com = _bcast(g.com, eff_axis, nd)
    d = _slab(Pt, ax, 1, None) - _slab(Pt, ax, 0, -1)
    h = _slab(com, ax, 1, None) - _slab(com, ax, 0, -1)
    one_sided = d / h
    slopes = van_albada(_slab(one_sided, ax, 0, -1), _slab(one_sided, ax, 1, None))
    cells = _slab(Pt, ax, 1, -1)
    del_n = _slab(_bcast(g.del_n, eff_axis, nd), ax, 1, -1)
    del_p = _slab(_bcast(g.del_p, eff_axis, nd), ax, 1, -1)
    lo = cells + slopes * del_n
    hi = cells + slopes * del_p
    # interface i+1/2 between padded cells (c, c+1):
    #   left state = hi-face state of c, right = lo-face state of c+1
    Pl = _slab(hi, ax, ng - 2, ng + n - 1)
    Pr = _slab(lo, ax, ng - 1, ng + n)
    slope_c = _slab(slopes, ax, ng - 1, ng + n - 1)
    return Pl, Pr, slope_c


def _riemann(Pl_r, Pr_r, cfg: SimConfig, dx_over_dt, hc_eta,
             hll_mask=None):
    """Dispatch on the configured flux solver (sweep frame).

    Mirrors reference solver dispatch (solver_eqn_hydro_adi.cpp:94-201,
    solver_eqn_mhd_adi.cpp:102-200).  Returns (flux, pstar).
    """
    s = cfg.solver
    if cfg.eqn is Eqn.EULER:
        if s is Solver.LF:
            return rh.lax_friedrichs(Pl_r, Pr_r, cfg, dx_over_dt)
        if s is Solver.HLL:
            return rh.hll(Pl_r, Pr_r, cfg)
        if s is Solver.RCV:
            return rh.roe_cv(Pl_r, Pr_r, cfg, hc_eta)
        if s is Solver.RPV:
            # distinct Roe-mean PV solver (reference:
            # Roe_Hydro_PrimitiveVar_solver.cpp), not the arithmetic-mean
            # linear solver
            return rh.roe_pv(Pl_r, Pr_r, cfg)
        if s is Solver.LINEAR:
            return rh.linear_pv(Pl_r, Pr_r, cfg)
        if s is Solver.EXACT:
            return rh.exact(Pl_r, Pr_r, cfg)
        if s is Solver.HYBRID:
            return rh.hybrid(Pl_r, Pr_r, cfg)
        if s is Solver.FVS:
            return rh.fvs(Pl_r, Pr_r, cfg)
        raise ValueError(f"unsupported hydro solver {s}")
    # MHD / GLM
    if s is Solver.LF:
        f, p = rh.lax_friedrichs(Pl_r, Pr_r, cfg, dx_over_dt)
        return f, p
    if s is Solver.HLL:
        return rm_to_pstar(rm.hll(Pl_r, Pr_r, cfg), cfg)
    if s is Solver.HLLD:
        return rm_to_pstar(
            rm.hlld_with_hll_fallback(Pl_r, Pr_r, cfg, hll_mask), cfg)
    if s is Solver.RCV:
        return rm_to_pstar(rm.roe_cv(Pl_r, Pr_r, cfg, hc_eta), cfg)
    if s in (Solver.LINEAR, Solver.EXACT, Solver.HYBRID, Solver.RPV):
        return rm_to_pstar(rm.linear(Pl_r, Pr_r, cfg), cfg)
    raise ValueError(f"unsupported MHD solver {s}")


def rm_to_pstar(fu, cfg):
    f, ustar = fu
    return f, cons_to_prim(ustar, cfg)


def _av_falle(flux, Pl, Pr, pstar, cfg: SimConfig):
    """FKJ98 viscous flux correction (reference:
    solver_eqn_hydro_adi.cpp:283-330, solver_eqn_mhd_adi.cpp:209-286)."""
    if cfg.eqn is Eqn.EULER:
        pref = maxspeed(pstar, cfg) * cfg.etav * pstar[RO]
    else:
        pref = (
            cfast_components(
                0.5 * (Pl[RO] + Pr[RO]),
                0.5 * (Pl[PG] + Pr[PG]),
                0.5 * (Pl[BX] + Pr[BX]),
                0.5 * (Pl[BY] + Pr[BY]),
                0.5 * (Pl[BZ] + Pr[BZ]),
                cfg.gamma,
            )
            * cfg.etav
            * pstar[RO]
        )
    erg = jnp.zeros_like(pref)
    for v in (VX, VY, VZ):
        mv = pref * (Pr[v] - Pl[v])
        flux = flux.at[v].add(-mv)
        erg = erg + mv * pstar[v]
    if cfg.eqn.is_mhd:
        prefb = pref / pstar[RO]  # etaB == etav (reference :277)
        for b in (BY, BZ):
            mv = prefb * (Pr[b] - Pl[b])
            flux = flux.at[b].add(-mv)
            erg = erg + mv * pstar[b]
    return flux.at[PG].add(-erg)


def calc_hcorr_eta(Ph_pad, cfg: SimConfig, geom: Geometry, order: int):
    """Per-cell, per-axis H-correction eta at each cell's positive face
    (Sanders, Morano & Druguet 1998 eq. 10; reference:
    solver_eqn_base.cpp:423-599).  Returns a list of padded arrays
    (no variable axis)."""
    etas = []
    for axis in range(cfg.ndim):
        ax = 1 + axis
        perm = sweep_perm(cfg, axis)
        g = geom.axes[axis]
        nd = cfg.ndim
        if order == 1:
            el = _slab(Ph_pad, ax, 0, -1)
            er = _slab(Ph_pad, ax, 1, None)
        else:
            com = _bcast(g.com, axis, nd)
            d = _slab(Ph_pad, ax, 1, None) - _slab(Ph_pad, ax, 0, -1)
            h = _slab(com, ax, 1, None) - _slab(com, ax, 0, -1)
            one_sided = d / h
            slopes = van_albada(_slab(one_sided, ax, 0, -1),
                                _slab(one_sided, ax, 1, None))
            z = jnp.zeros_like(_slab(Ph_pad, ax, 0, 1))
            slopes_full = jnp.concatenate([z, slopes, z], axis=ax)
            lo = Ph_pad + slopes_full * _bcast(g.del_n, axis, nd)
            hi = Ph_pad + slopes_full * _bcast(g.del_p, axis, nd)
            el = _slab(hi, ax, 0, -1)
            er = _slab(lo, ax, 1, None)
        el_r = el[perm]
        er_r = er[perm]
        eta = 0.5 * (
            jnp.abs(er_r[VX] - el_r[VX])
            + jnp.abs(maxspeed(er_r, cfg) - maxspeed(el_r, cfg))
        )
        # store at the cell owning the positive face; pad the last cell
        pad = jnp.zeros_like(_slab(eta[None], ax, 0, 1)[0])
        etas.append(jnp.concatenate([eta, pad], axis=axis))
    return etas


def hlld_fallback_cells(Ph_pad, cfg: SimConfig, dx: float):
    """Per-cell div(v) and pressure-jump measure for the HLLD->HLL switch
    (Mignone et al. 2011; reference: solver_eqn_base.cpp:398-412 preprocess
    sets DivV and MagGradP = sum_axes |dp|/min(p), threshold 5 at
    solver_eqn_mhd_adi.cpp:167-182).  Computed on the padded array so the
    one-ghost-deep cells used by boundary interfaces are covered.

    All terms are evaluated on the aligned 1-ring region (every spatial
    axis sliced to 1..npad-2) so the whole mask is one fused elementwise
    pass over shifted slices of the same array, then zero-padded back to
    the padded shape with a single pad.  Both sweep drivers only read the
    mask at cells 1..npad-2 along the sweep axis and interior transverse
    cells, so the zero edge layer never feeds an interface (an
    edge-clamped ``jnp.concatenate`` form would materialize twelve
    full-grid copies)."""
    nd = cfg.ndim
    p = Ph_pad[PG]

    def ring(A, ax0, shift):
        # A sliced to the 1-ring region, offset by ``shift`` along ax0
        return A[tuple(slice(1 + shift, A.shape[a] - 1 + shift)
                       if a == ax0 else slice(1, -1)
                       for a in range(nd))]

    divv = None
    gradp = None
    for ax0 in range(nd):
        k = nd - 1 - ax0
        v = Ph_pad[VX + k]
        d = (ring(v, ax0, 1) - ring(v, ax0, -1)) / (2.0 * dx)
        divv = d if divv is None else divv + d
        phi = ring(p, ax0, 1)
        plo = ring(p, ax0, -1)
        gz = jnp.abs(phi - plo) / jnp.minimum(phi, plo)
        gradp = gz if gradp is None else gradp + gz
    strong = (divv < 0.0) & (gradp > 5.0)
    return jnp.pad(strong, [(1, 1)] * nd)


def _select_hcorr_eta(etas, cfg: SimConfig, axis: int, n: int):
    """Max eta over the H-stencil of each interface along ``axis``
    (reference: solver_eqn_base.cpp:608-678, Sanders et al. 1998 fig. 9).
    Returns an interface array (interior transverse dims, n+1 along axis)."""
    ng = cfg.ng

    def interior_t(cells):
        sl = [slice(ng, -ng) if a != axis else slice(None)
              for a in range(cfg.ndim)]
        return cells[tuple(sl)]

    eta_ax = interior_t(etas[axis])
    eta = _slab(eta_ax[None], 1 + axis, ng - 1, ng + n)[0]
    for p in range(cfg.ndim):
        if p == axis:
            continue
        ep = etas[p]
        first = _slab(ep[None], 1 + p, 0, 1)[0]
        ep_nm = jnp.concatenate([first, _slab(ep[None], 1 + p, 0, -1)[0]],
                                axis=p)
        m = interior_t(jnp.maximum(ep, ep_nm))
        eta = jnp.maximum(eta, _slab(m[None], 1 + axis, ng - 1, ng + n)[0])
        eta = jnp.maximum(eta, _slab(m[None], 1 + axis, ng, ng + n + 1)[0])
    return eta


def dynamics_dU(
    Ph_pad: jnp.ndarray,
    cfg: SimConfig,
    geom: Geometry,
    dt,
    order: int,
    ch=None,
    scma: bool = False,
) -> Tuple[jnp.ndarray, List[jnp.ndarray]]:
    """dt * (-div F + geometric/Powell/GLM sources) for all interior cells.

    ``Ph_pad`` is the primitive state padded with ``ng`` ghost cells on every
    axis (boundary conditions already applied).  ``order`` is the spatial
    order for this partial step (1 on the predictor half-step, cfg.ooa on the
    corrector — reference: time_integrator.cpp:151-243).
    """
    ng = cfg.ng
    dx = geom.dx
    nd = cfg.ndim
    glm = cfg.eqn is Eqn.GLM
    if glm and ch is None:
        # hyperbolic cleaning speed c_h = cfl*dx/t_dyn; the driver passes the
        # full-step value (reference: solver_eqn_mhd_adi.cpp:906-922 via
        # calc_timestep.cpp:112-139) so the half-step reuses it.
        ch = cfg.cfl * dx / dt

    etas = None
    if cfg.av in (AV.HCORR, AV.HCORR_FALLE):
        etas = calc_hcorr_eta(Ph_pad, cfg, geom, order)

    hlld_strong = None
    if (cfg.solver is Solver.HLLD and cfg.eqn.is_mhd
            and cfg.hlld_fallback):
        hlld_strong = hlld_fallback_cells(Ph_pad, cfg, dx)

    dU = None
    face_fluxes: List[jnp.ndarray] = []
    for axis in range(nd):
        n = cfg.shape[axis]
        # interior on transverse axes only; sweep axis stays padded.
        # Hybrid layout: for non-minor axes one explicit transpose puts the
        # sweep axis last, so the whole elementwise Riemann pipeline runs
        # over the contiguous minor dimension instead of strided slices
        # along a middle axis.
        Pt = _interior(Ph_pad, cfg, skip_axis=axis)
        eff = nd - 1
        if axis != nd - 1:
            Pt = jnp.moveaxis(Pt, 1 + axis, -1)
        ax = 1 + eff
        Pl, Pr, slope_c = _reconstruct(Pt, cfg, geom, axis, order, eff)

        perm = sweep_perm(cfg, axis)
        inv = inverse_perm(perm)
        Pl_r = Pl[perm]
        Pr_r = Pr[perm]

        hc_eta = None
        if etas is not None:
            hc_eta = _select_hcorr_eta(etas, cfg, axis, n)
            if axis != nd - 1:
                # hybrid layout: the sweep axis was moved to last (see Pt
                # above); the eta interface array must follow (only the
                # Roe solvers consume it, which is why hybrid/HLL hcorr
                # runs never tripped this)
                hc_eta = jnp.moveaxis(hc_eta[None], 1 + axis, -1)[0]

        hll_mask = None
        if hlld_strong is not None:
            # interface uses HLL when either adjacent cell is flagged
            sm = hlld_strong
            sl_t = [slice(ng, -ng) if a != axis else slice(None)
                    for a in range(nd)]
            smi = sm[tuple(sl_t)]
            ml = _slab(smi[None], 1 + axis, ng - 1, ng + n)[0]
            mr = _slab(smi[None], 1 + axis, ng, ng + n + 1)[0]
            hll_mask = ml | mr
            if axis != nd - 1:
                hll_mask = jnp.moveaxis(hll_mask[None], 1 + axis, -1)[0]

        psistar = bxstar = None
        if glm:
            # Dedner 2x2 Riemann problem for (Bx, psi)
            # (reference: solver_eqn_mhd_adi.cpp:724-738)
            psistar = 0.5 * (Pl_r[SI] + Pr_r[SI] - (Pr_r[BX] - Pl_r[BX]))
            bxstar = 0.5 * (Pl_r[BX] + Pr_r[BX] - (Pr_r[SI] - Pl_r[SI]))
            Pl_r = Pl_r.at[SI].set(0.0).at[BX].set(bxstar)
            Pr_r = Pr_r.at[SI].set(0.0).at[BX].set(bxstar)

        flux_r, pstar = _riemann(Pl_r, Pr_r, cfg, dx / dt, hc_eta,
                                 hll_mask=hll_mask)

        if glm:
            # Mackey & Lim (2011) energy correction + Dedner fluxes
            # (reference: solver_eqn_mhd_adi.cpp:760-762)
            flux_r = flux_r.at[PG].add(ch * bxstar * psistar)
            flux_r = flux_r.at[BX].set(ch * psistar)
            flux_r = flux_r.at[SI].set(ch * bxstar)

        if cfg.av in (AV.FALLE, AV.HCORR_FALLE):
            flux_r = _av_falle(flux_r, Pl_r, Pr_r, pstar, cfg)

        # Tracer advection: upwind on the mass flux
        # (reference: solver_eqn_base.cpp:281-342)
        if cfg.ntracer:
            fm = flux_r[RO]
            tr = cfg.tracer_slice
            Plt, Prt = Pl_r[tr], Pr_r[tr]
            if scma:
                # sCMA corrector (Plewa & Muller 1999; reference:
                # microphysics_base.cpp:80-131 + solver_eqn_base.cpp:320-334):
                # tracers above 1 advect as 1 (corrector = 1/p; the p<0 -> 0
                # branch upstream is dead code, overwritten on the next line,
                # so negative values pass through unchanged).  Only active
                # when a microphysics module owns the tracers.
                Plt = jnp.minimum(Plt, 1.0)
                Prt = jnp.minimum(Prt, 1.0)
                if isinstance(scma, (tuple, list)) and len(scma):
                    # element mass-fraction renormalization: the declared
                    # element tracers advect with values scaled so their
                    # clamped sum is 1 (reference:
                    # microphysics_base.cpp:96-118)
                    Plt, Prt = _scma_elements(Plt, Prt, Pl_r, Pr_r,
                                              scma, cfg)
            f_tr = jnp.where(fm > 0.0, Plt * fm, Prt * fm)
            f_tr = jnp.where(fm == 0.0, 0.0, f_tr)
            flux_r = flux_r.at[tr].set(f_tr)

        flux = flux_r[inv]

        # -div(F): per-axis divergence with metric coefficients
        # (reference: VectorOps.cpp:624-644, :1215-1244,
        # VectorOps_spherical.cpp:449-484)
        g = geom.axes[axis]
        cn = _bcast(g.div_cn, eff, nd)
        cp = _bcast(g.div_cp, eff, nd)
        dudt = cn * _slab(flux, ax, 0, -1) - cp * _slab(flux, ax, 1, None)

        Pc = _slab(Pt, ax, ng, ng + n)  # interior cells

        # Geometric source on the radial axis
        # (reference: solver_eqn_hydro_adi.cpp:560-707)
        if g.is_radial:
            k_norm = VX + (nd - 1 - axis)
            pos_c = _bcast(g.pos[ng : ng + n], eff, nd)[0]
            com_c = _bcast(g.com[ng : ng + n], eff, nd)[0]
            if cfg.coords is Coord.CYLINDRICAL:
                if cfg.eqn.is_mhd:
                    # radial momentum source includes the MAGNETIC
                    # pressure, with the B.dB slope correction at OA2
                    # (reference: cyl_FV_solver_mhd_*::geometric_source,
                    # solver_eqn_mhd_adi.cpp:1001-1030,1180-1215)
                    pm = 0.5 * (Pc[BX] ** 2 + Pc[BY] ** 2 + Pc[BZ] ** 2)
                    if order == 1:
                        src = (Pc[PG] + pm) / pos_c
                    else:
                        corr = (slope_c[PG] + Pc[BX] * slope_c[BX]
                                + Pc[BY] * slope_c[BY]
                                + Pc[BZ] * slope_c[BZ])
                        src = (Pc[PG] + pm
                               + (pos_c - com_c) * corr) / pos_c
                elif order == 1:
                    src = Pc[PG] / pos_c
                else:
                    src = (Pc[PG] + (pos_c - com_c) * slope_c[PG]) / pos_c
            else:  # spherical; R3 = r + dr^2/(12 r)
                r3 = pos_c + dx * dx / 12.0 / pos_c
                if order == 1:
                    src = 2.0 * Pc[PG] / r3
                else:
                    src = 2.0 * ((Pc[PG] - slope_c[PG] * com_c) / r3
                                 + slope_c[PG])
            dudt = dudt.at[k_norm].add(src)
            if glm and cfg.coords is Coord.CYLINDRICAL:
                # GLM radial-B geometric source c_h psi / R (reference:
                # cyl_FV_solver_mhd_mixedGLM_adi::geometric_source,
                # solver_eqn_mhd_adi.cpp:1203-1215)
                kb = BX + (nd - 1 - axis)
                if order == 1:
                    sb = ch * Pc[SI] / pos_c
                else:
                    sb = ch * (Pc[SI]
                               + (pos_c - com_c) * slope_c[SI]) / pos_c
                dudt = dudt.at[kb].add(sb)

        # Powell 8-wave source terms (MHD; reference:
        # solver_eqn_mhd_adi.cpp:396-443): dU_i -= (d<Bn>/dx) * S_i
        if cfg.eqn.is_mhd:
            k = nd - 1 - axis
            bn = Pt[BX + k]  # padded along sweep axis; spatial axis = `axis`
            bm = 0.5 * (_slab(bn[None], ax, ng - 1, ng + n)[0]
                        + _slab(bn[None], ax, ng, ng + n + 1)[0])
            if g.is_radial and cfg.coords is Coord.CYLINDRICAL:
                # cylindrical radial divergence factors 2 r_face/(rp^2-rn^2)
                # (reference: cyl_FV_solver_mhd_ideal_adi::MHDsource Rcyl
                # branch, solver_eqn_mhd_adi.cpp:1092-1103)
                dbm = (cn[0] * _slab(bm[None], ax, 0, -1)[0]
                       - cp[0] * _slab(bm[None], ax, 1, None)[0])
            else:
                dbm = (_slab(bm[None], ax, 0, -1)[0]
                       - _slab(bm[None], ax, 1, None)[0]) / dx
            udotb = Pc[VX] * Pc[BX] + Pc[VY] * Pc[BY] + Pc[VZ] * Pc[BZ]
            dudt = dudt.at[VX].add(dbm * Pc[BX])
            dudt = dudt.at[VY].add(dbm * Pc[BY])
            dudt = dudt.at[VZ].add(dbm * Pc[BZ])
            dudt = dudt.at[PG].add(dbm * udotb)
            dudt = dudt.at[BX].add(dbm * Pc[VX])
            dudt = dudt.at[BY].add(dbm * Pc[VY])
            dudt = dudt.at[BZ].add(dbm * Pc[VZ])
            if glm:
                # GLM advective psi source (reference:
                # solver_eqn_mhd_adi.cpp:782-813)
                psi = Pt[SI]
                sm = 0.5 * (_slab(psi[None], ax, ng - 1, ng + n)[0]
                            + _slab(psi[None], ax, ng, ng + n + 1)[0])
                dsm = (_slab(sm[None], ax, 0, -1)[0]
                       - _slab(sm[None], ax, 1, None)[0]) / dx
                vn = Pc[VX + k]
                dudt = dudt.at[PG].add(dsm * vn * Pc[SI])
                dudt = dudt.at[SI].add(dsm * vn)

        if axis != nd - 1:
            dudt = jnp.moveaxis(dudt, -1, 1 + axis)
            flux = jnp.moveaxis(flux, -1, 1 + axis)
        face_fluxes.append(flux)
        contrib = dt * dudt
        dU = contrib if dU is None else dU + contrib

    return dU, face_fluxes

