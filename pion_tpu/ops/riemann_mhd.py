"""MHD Riemann solvers, vectorized over interface arrays.

JAX equivalents of the reference MHD solver menu
(reference: source/Riemann_solvers/HLLD_MHD.cpp (Miyoshi & Kusano 2005),
Roe_MHD_ConservedVar_solver.cpp (Cargo & Gallice 1997), riemannMHD.cpp
(Falle et al. 1998 linear eigenvector solver)).

All functions work in the sweep frame (VX/BX normal) and return
``(flux, ustar)`` in conserved variables for the interface state (matching
the reference, which converts ustar->pstar afterwards).  Only the 8 physical
slots are populated; psi/tracer slots are zeroed (the sweep driver owns the
Dedner 2x2 psi flux and tracer upwinding).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..config import SimConfig
from ..constants import BX, BY, BZ, PG, RO, VX, VY, VZ
from .eqns import cfast_components, flux_from_prim, prim_to_cons

_TINY = 1.0e-30


def _signal_speeds(Pl, Pr, cfg: SimConfig):
    """HLL/HLLD wave-speed estimates (reference: HLLD_MHD.cpp:342-368)."""
    bx = 0.5 * (Pl[BX] + Pr[BX])
    cf_l = cfast_components(Pl[RO], Pl[PG], bx, Pl[BY], Pl[BZ], cfg.gamma)
    cf_r = cfast_components(Pr[RO], Pr[PG], bx, Pr[BY], Pr[BZ], cfg.gamma)
    cmax = jnp.maximum(cf_l, cf_r)
    sl = jnp.minimum(Pl[VX], Pr[VX]) - cmax
    sr = jnp.maximum(Pl[VX], Pr[VX]) + cmax
    return sl, sr


def _interface_common(Pl, Pr, cfg: SimConfig):
    """Conserved states, fluxes and HLL wave speeds for one interface —
    shared between HLLD and its HLL fallback so the fallback costs only the
    (cheap) HLL mid-state algebra, not a second full state conversion."""
    from .eqns import flux_from_pu

    ul = prim_to_cons(Pl, cfg)
    ur = prim_to_cons(Pr, cfg)
    fl = flux_from_pu(Pl, ul, cfg)
    fr = flux_from_pu(Pr, ur, cfg)
    sl, sr = _signal_speeds(Pl, Pr, cfg)
    return ul, ur, fl, fr, sl, sr


def hll(Pl, Pr, cfg: SimConfig, common=None):
    """Two-wave HLL flux (reference: HLLD_MHD.cpp:380-430 MHD_HLL_flux_solver).

    Single-formula form with clamped wave speeds lp=max(sr,0), lm=min(sl,0):
    f = (lp*fl - lm*fr + lp*lm*(ur-ul)) / (lp-lm) reproduces all three
    regions of the reference's if-tree exactly (sl>0 -> lp/lp=1 -> fl;
    sr<0 -> fr; else the mid-state flux) without per-channel selects."""
    ul, ur, fl, fr, sl, sr = common or _interface_common(Pl, Pr, cfg)
    lp = jnp.maximum(sr, 0.0)
    lm = jnp.minimum(sl, 0.0)
    inv = 1.0 / (lp - lm)
    c_l = lp * inv
    c_r = -lm * inv
    c_u = lp * lm * inv
    f = c_l * fl + c_r * fr + c_u * (ur - ul)
    ustar = (sr * ur - sl * ul + fl - fr) / (sr - sl)
    return f, ustar


def hlld(Pl, Pr, cfg: SimConfig, common=None):
    """HLLD five-wave solver (Miyoshi & Kusano 2005; reference:
    HLLD_MHD.cpp:120-335).  Branch structure becomes nested ``where`` masks;
    the Bx->0 degeneracy is guarded exactly as in the paper (eq. 44-47)."""
    g = cfg.gamma
    bx = 0.5 * (Pl[BX] + Pr[BX])

    ul, ur, fl, fr, sl, sr = common or _interface_common(Pl, Pr, cfg)

    ptl = Pl[PG] + 0.5 * (bx * bx + Pl[BY] ** 2 + Pl[BZ] ** 2)
    ptr = Pr[PG] + 0.5 * (bx * bx + Pr[BY] ** 2 + Pr[BZ] ** 2)
    sl_vl = sl - Pl[VX]
    sr_vr = sr - Pr[VX]
    inv_denom = 1.0 / (sr_vr * Pr[RO] - sl_vl * Pl[RO])
    # entropy-wave speed S_M (m05 eq. 38)
    sm = (sr_vr * ur[VX] - sl_vl * ul[VX] - ptr + ptl) * inv_denom
    # total pressure in the star region (m05 eq. 41)
    pts = (sr_vr * Pr[RO] * ptl - sl_vl * Pl[RO] * ptr
           + Pl[RO] * Pr[RO] * sr_vr * sl_vl * (Pr[VX] - Pl[VX])) * inv_denom

    def star(PK, uK, sK, sK_vK, ptK):
        sK_sm = sK - sm
        inv_sK_sm = 1.0 / sK_sm
        rho_s = PK[RO] * sK_vK * inv_sK_sm                  # m05 eq. 43
        # m05 eq. 44/46-47 with degeneracy guard
        dd = PK[RO] * sK_vK * sK_sm - bx * bx
        degenerate = jnp.abs(dd) < _TINY * (PK[RO] * sK_vK * sK_vK + bx * bx + _TINY)
        inv_dd = 1.0 / jnp.where(degenerate, 1.0, dd)
        fac_v = bx * (sm - PK[VX]) * inv_dd
        vy_s = jnp.where(degenerate, PK[VY], PK[VY] - PK[BY] * fac_v)
        vz_s = jnp.where(degenerate, PK[VZ], PK[VZ] - PK[BZ] * fac_v)
        fac_b = (PK[RO] * sK_vK * sK_vK - bx * bx) * inv_dd
        by_s = jnp.where(degenerate, PK[BY], PK[BY] * fac_b)
        bz_s = jnp.where(degenerate, PK[BZ], PK[BZ] * fac_b)
        vdotb_K = PK[VX] * bx + PK[VY] * PK[BY] + PK[VZ] * PK[BZ]
        vdotb_s = sm * bx + vy_s * by_s + vz_s * bz_s
        e_s = (sK_vK * uK[PG] - ptK * PK[VX] + pts * sm
               + bx * (vdotb_K - vdotb_s)) * inv_sK_sm       # m05 eq. 48
        us = [rho_s, e_s, rho_s * sm, rho_s * vy_s, rho_s * vz_s,
              jnp.full_like(rho_s, 1.0) * bx, by_s, bz_s]
        pad = [jnp.zeros_like(rho_s)] * (PK.shape[0] - 8)
        return jnp.stack(us + pad), vy_s, vz_s, by_s, bz_s

    uls, vyl_s, vzl_s, byl_s, bzl_s = star(Pl, ul, sl, sl_vl, ptl)
    urs, vyr_s, vzr_s, byr_s, bzr_s = star(Pr, ur, sr, sr_vr, ptr)

    # Alfven-wave speeds in the star region (m05 eq. 51)
    sqrt_rls = jnp.sqrt(uls[RO])
    sqrt_rrs = jnp.sqrt(urs[RO])
    sls = sm - jnp.abs(bx) / sqrt_rls
    srs = sm + jnp.abs(bx) / sqrt_rrs

    # double-star states (m05 eq. 59-62)
    sgn_bx = jnp.sign(bx) + (bx == 0.0)  # sign(0) := +1 to avoid NaNs
    inv_ssum = 1.0 / (sqrt_rls + sqrt_rrs)
    sqrt_rlrs = sqrt_rls * sqrt_rrs
    vy_ss = (sqrt_rls * vyl_s + sqrt_rrs * vyr_s + (byr_s - byl_s) * sgn_bx) * inv_ssum
    vz_ss = (sqrt_rls * vzl_s + sqrt_rrs * vzr_s + (bzr_s - bzl_s) * sgn_bx) * inv_ssum
    by_ss = (sqrt_rls * byr_s + sqrt_rrs * byl_s
             + sqrt_rlrs * (vyr_s - vyl_s) * sgn_bx) * inv_ssum
    bz_ss = (sqrt_rls * bzr_s + sqrt_rrs * bzl_s
             + sqrt_rlrs * (vzr_s - vzl_s) * sgn_bx) * inv_ssum
    vdotb_ss = sm * bx + vy_ss * by_ss + vz_ss * bz_ss

    def dstar(us, sq, vy_s, vz_s, by_s, bz_s, sgn):
        rho = us[RO]
        vdotb_s = sm * bx + vy_s * by_s + vz_s * bz_s
        e_ss = us[PG] + sgn * sq * (vdotb_s - vdotb_ss) * sgn_bx  # m05 eq. 63
        uss = [rho, e_ss, rho * sm, rho * vy_ss, rho * vz_ss,
               jnp.ones_like(rho) * bx, by_ss, bz_ss]
        pad = [jnp.zeros_like(rho)] * (us.shape[0] - 8)
        return jnp.stack(uss + pad)

    ulss = dstar(uls, sqrt_rls, vyl_s, vzl_s, byl_s, bzl_s, -1.0)
    urss = dstar(urs, sqrt_rrs, vyr_s, vzr_s, byr_s, bzr_s, +1.0)

    # Flux assembly (m05 eq. 64-66; reference :294-325)
    f_ls = fl + sl * (uls - ul)
    f_lss = fl + sls * ulss - (sls - sl) * uls - sl * ul
    f_rss = fr + srs * urss - (srs - sr) * urs - sr * ur
    f_rs = fr + sr * (urs - ur)

    f = jnp.where(
        sl > 0.0, fl,
        jnp.where(
            sls >= 0.0, f_ls,
            jnp.where(
                sm >= 0.0, f_lss,
                jnp.where(srs >= 0.0, f_rss, jnp.where(sr >= 0.0, f_rs, fr)),
            ),
        ),
    )
    ustar = jnp.where(
        sl > 0.0, ul,
        jnp.where(
            sls >= 0.0, uls,
            jnp.where(
                sm >= 0.0, ulss,
                jnp.where(srs >= 0.0, urss, jnp.where(sr >= 0.0, urs, ur)),
            ),
        ),
    )
    return f, ustar


def hlld_with_hll_fallback(Pl, Pr, cfg: SimConfig, use_hll_mask=None):
    """HLLD with per-interface HLL fallback in compressive strong-gradient
    zones (reference: solver_eqn_mhd_adi.cpp:167-185, Mignone et al. 2011).

    ``use_hll_mask`` is a boolean interface array computed by the sweep driver
    from div(v)<0 and |grad p|*dx/p > 5.  The conserved states, fluxes and
    wave speeds are computed once and shared between both solvers.
    """
    if use_hll_mask is None:
        return hlld(Pl, Pr, cfg)
    common = _interface_common(Pl, Pr, cfg)
    f_d, u_d = hlld(Pl, Pr, cfg, common)
    f_h, u_h = hll(Pl, Pr, cfg, common)
    return (
        jnp.where(use_hll_mask, f_h, f_d),
        jnp.where(use_hll_mask, u_h, u_d),
    )


# ---------------------------------------------------------------------------
# Linear (primitive-variable) MHD solver — Falle, Komissarov & Joarder 1998
# with Roe & Balsara (1996) eigenvector normalization
# (reference: riemannMHD.cpp:540-1110; PION's FLUX_RSlinear/RSexact for MHD)
# ---------------------------------------------------------------------------

def linear(Pl, Pr, cfg: SimConfig):
    """7-wave linear solver about the arithmetic-mean state.

    Computes the resolved state P* by crossing all waves with negative speed
    from the left state (reference: riemannMHD.cpp:849-905), then returns
    ``(flux(P*), U(P*))``.  The interface Bx is the input mean (the GLM/ideal
    sweep driver has already replaced both sides' Bx).
    """
    g = cfg.gamma
    sqrt2 = jnp.sqrt(2.0)
    bx_i = 0.5 * (Pl[BX] + Pr[BX])
    rho = 0.5 * (Pl[RO] + Pr[RO])
    pg = 0.5 * (Pl[PG] + Pr[PG])
    vx = 0.5 * (Pl[VX] + Pr[VX])
    vy = 0.5 * (Pl[VY] + Pr[VY])
    vz = 0.5 * (Pl[VZ] + Pr[VZ])
    by = 0.5 * (Pl[BY] + Pr[BY])
    bz = 0.5 * (Pl[BZ] + Pr[BZ])
    sqrt_rho = jnp.sqrt(rho)

    a = jnp.sqrt(g * pg / rho)                       # hydro sound speed
    bxa = bx_i / sqrt_rho
    ca = jnp.abs(bxa)
    bt2 = (by * by + bz * bz) / rho
    bt = jnp.sqrt(bt2)
    tiny = 1.0e-12 * (a + ca + bt)
    degen_t = bt <= tiny
    bt_safe = jnp.where(degen_t, 1.0, bt)
    betay = jnp.where(degen_t, 1.0 / sqrt2, by / (sqrt_rho * bt_safe))
    betaz = jnp.where(degen_t, 1.0 / sqrt2, bz / (sqrt_rho * bt_safe))

    t1 = a * a + ca * ca + bt2
    t2 = jnp.maximum(t1 * t1 - 4.0 * a * a * ca * ca, _TINY)
    cf = jnp.sqrt(0.5 * (t1 + jnp.sqrt(t2)))
    cs = jnp.sqrt(0.5 * jnp.maximum(t1 - jnp.sqrt(t2), _TINY))
    # ordering guards (reference: riemannMHD.cpp:695-705)
    small = 1.0e-12 * a
    cs = jnp.minimum(cs, a - small)
    cf = jnp.maximum(cf, a + small)
    cs = jnp.clip(cs, 0.0, jnp.maximum(ca - small, 0.5 * ca))
    cf = jnp.maximum(cf, ca + small)

    cf2_cs2 = jnp.maximum(cf * cf - cs * cs, _TINY)
    alphaf = jnp.sqrt(jnp.clip((a * a - cs * cs) / cf2_cs2, 0.0, 1.0))
    alphas = jnp.sqrt(jnp.clip((cf * cf - a * a) / cf2_cs2, 0.0, 1.0))
    sbx = jnp.sign(bx_i) + (bx_i == 0.0)

    # primitive jumps (no Bx slot)
    d_ro = Pr[RO] - Pl[RO]
    d_pg = Pr[PG] - Pl[PG]
    d_vx = Pr[VX] - Pl[VX]
    d_vy = Pr[VY] - Pl[VY]
    d_vz = Pr[VZ] - Pl[VZ]
    d_by = Pr[BY] - Pl[BY]
    d_bz = Pr[BZ] - Pl[BZ]

    inv2a2 = 1.0 / (2.0 * a * a)
    # wave strengths = l_i . dP  (reference: riemannMHD.cpp:987-1041,813-820;
    # fast/slow left eigenvectors carry the 1/(2a^2) normalization)
    s_fn = inv2a2 * (
        -alphaf * cf * d_vx
        + alphas * cs * sbx * (betay * d_vy + betaz * d_vz)
        + alphaf * d_pg / rho
        + alphas * a * (betay * d_by + betaz * d_bz) / sqrt_rho
    )
    s_fp = inv2a2 * (
        +alphaf * cf * d_vx
        - alphas * cs * sbx * (betay * d_vy + betaz * d_vz)
        + alphaf * d_pg / rho
        + alphas * a * (betay * d_by + betaz * d_bz) / sqrt_rho
    )
    s_sn = inv2a2 * (
        -alphas * cs * d_vx
        - alphaf * cf * sbx * (betay * d_vy + betaz * d_vz)
        + alphas * d_pg / rho
        - alphaf * a * (betay * d_by + betaz * d_bz) / sqrt_rho
    )
    s_sp = inv2a2 * (
        +alphas * cs * d_vx
        + alphaf * cf * sbx * (betay * d_vy + betaz * d_vz)
        + alphas * d_pg / rho
        - alphaf * a * (betay * d_by + betaz * d_bz) / sqrt_rho
    )
    s_an = (sbx * (betaz * d_vy - betay * d_vz)
            + (betaz * d_by - betay * d_bz) / sqrt_rho) / sqrt2
    s_ap = (sbx * (betaz * d_vy - betay * d_vz)
            - (betaz * d_by - betay * d_bz) / sqrt_rho) / sqrt2
    s_ct = d_ro - d_pg / (a * a)

    # Right eigenvectors, slots (ro, pg, vx, vy, vz, by, bz).  The minus
    # (sgn_wave=+1) fast wave has velocity components (-alphaf*cf,
    # +alphas*cs*sbx*beta_t); the plus wave negates all velocity slots
    # (reference: riemannMHD.cpp:1044-1098).
    def rev(sgn_wave, kind):
        if kind == "fast":
            v = (-alphaf * cf, alphas * cs * sbx * betay, alphas * cs * sbx * betaz)
            return (
                alphaf * rho, alphaf * rho * a * a,
                sgn_wave * v[0], sgn_wave * v[1], sgn_wave * v[2],
                alphas * a * betay * sqrt_rho, alphas * a * betaz * sqrt_rho,
            )
        if kind == "slow":
            v = (-alphas * cs, -alphaf * cf * sbx * betay, -alphaf * cf * sbx * betaz)
            return (
                alphas * rho, alphas * rho * a * a,
                sgn_wave * v[0], sgn_wave * v[1], sgn_wave * v[2],
                -alphaf * a * betay * sqrt_rho, -alphaf * a * betaz * sqrt_rho,
            )
        if kind == "alfven":
            z = jnp.zeros_like(rho)
            return (
                z, z, z,
                sbx * betaz / sqrt2, -sbx * betay / sqrt2,
                sgn_wave * betaz * sqrt_rho / sqrt2,
                sgn_wave * (-betay) * sqrt_rho / sqrt2,
            )
        # contact
        z = jnp.zeros_like(rho)
        return (jnp.ones_like(rho), z, z, z, z, z, z)

    waves = [
        (vx - cf, s_fn, rev(+1.0, "fast")),
        (vx - ca, s_an, rev(+1.0, "alfven")),
        (vx - cs, s_sn, rev(+1.0, "slow")),
        (vx, s_ct, rev(0.0, "contact")),
        (vx + cs, s_sp, rev(-1.0, "slow")),
        (vx + ca, s_ap, rev(-1.0, "alfven")),
        (vx + cf, s_fp, rev(-1.0, "fast")),
    ]

    # P* = P_left + sum over waves with lambda<0 of strength*r
    slots = [RO, PG, VX, VY, VZ, BY, BZ]
    star = {s: Pl[s] for s in slots}
    for lam, st, r in waves:
        neg = lam < 0.0
        for s, rc in zip(slots, r):
            star[s] = star[s] + jnp.where(neg, st * rc, 0.0)

    # Contact-straddling symmetrization (reference: riemannMHD.cpp:884-905):
    # when |vx_mean| is tiny, average left-crossing and right-crossing answers.
    near_ct = jnp.abs(vx) < 1.0e-4 * a
    star_r = {s: Pr[s] for s in slots}
    for lam, st, r in waves:
        pos = lam > 0.0
        for s, rc in zip(slots, r):
            star_r[s] = star_r[s] - jnp.where(pos, st * rc, 0.0)
    for s in slots:
        star[s] = jnp.where(near_ct, 0.5 * (star[s] + star_r[s]), star[s])

    ro_s = jnp.maximum(star[RO], _TINY)
    pg_s = jnp.maximum(star[PG], _TINY)
    nvar = Pl.shape[0]
    pad = [jnp.zeros_like(rho)] * (nvar - 8)
    Pstar = jnp.stack(
        [ro_s, pg_s, star[VX], star[VY], star[VZ],
         jnp.ones_like(rho) * bx_i, star[BY], star[BZ]] + pad
    )
    return flux_from_prim(Pstar, cfg), prim_to_cons(Pstar, cfg)


def roe_cv(Pl, Pr, cfg: SimConfig, hc_eta=None):
    """Roe conserved-variable MHD flux, symmetric sum-over-waves form
    (Cargo & Gallice 1997; reference:
    Roe_MHD_ConservedVar_solver.cpp:218-297,345-833 — Roe-averaged state,
    CG97 X-parameter sound speed, Roe-Balsara normalized strengths and
    conserved-variable right eigenvectors, H-correction eigenvalue floors).
    """
    g = cfg.gamma
    rl = jnp.sqrt(Pl[RO])
    rr = jnp.sqrt(Pr[RO])
    denom = 1.0 / (rl + rr)
    rho = rl * rr
    sqrt_rho = jnp.sqrt(rho)
    vx = (rl * Pl[VX] + rr * Pr[VX]) * denom
    vy = (rl * Pl[VY] + rr * Pr[VY]) * denom
    vz = (rl * Pl[VZ] + rr * Pr[VZ]) * denom
    # note swapped weights for the transverse field (reference :363-364)
    by = (rr * Pl[BY] + rl * Pr[BY]) * denom
    bz = (rr * Pl[BZ] + rl * Pr[BZ]) * denom
    bx = 0.5 * (Pl[BX] + Pr[BX])
    sgn_bx = jnp.where(bx >= 0.0, 1.0, -1.0)

    ul = prim_to_cons(Pl, cfg)
    ur = prim_to_cons(Pr, cfg)
    # total enthalpy (E + p_g + B^2/2)/rho
    b2l = Pl[BX] ** 2 + Pl[BY] ** 2 + Pl[BZ] ** 2
    b2r = Pr[BX] ** 2 + Pr[BY] ** 2 + Pr[BZ] ** 2
    Hl = (ul[PG] + Pl[PG] + 0.5 * b2l) / Pl[RO]
    Hr = (ur[PG] + Pr[PG] + 0.5 * b2r) / Pr[RO]
    H = (rl * Hl + rr * Hr) * denom

    V2 = vx * vx + vy * vy + vz * vz
    B = jnp.sqrt(bx * bx + by * by + bz * bz)
    Bt = jnp.sqrt(by * by + bz * bz)
    degen = Bt < _TINY
    bty = jnp.where(degen, 1.0 / jnp.sqrt(2.0),
                    by / jnp.where(degen, 1.0, Bt))
    btz = jnp.where(degen, 1.0 / jnp.sqrt(2.0),
                    bz / jnp.where(degen, 1.0, Bt))

    # conserved/primitive jumps; the CG97 "X" parameter and effective dp
    # (reference: Roe_get_difference_states:417-470)
    du_mx = ur[VX] - ul[VX]
    du_my = ur[VY] - ul[VY]
    du_mz = ur[VZ] - ul[VZ]
    du_e = ur[PG] - ul[PG]
    d_ro = Pr[RO] - Pl[RO]
    d_vx = Pr[VX] - Pl[VX]
    d_vy = Pr[VY] - Pl[VY]
    d_vz = Pr[VZ] - Pl[VZ]
    d_by = Pr[BY] - Pl[BY]
    d_bz = Pr[BZ] - Pl[BZ]
    X = (d_by * d_by + d_bz * d_bz) * 0.5 * denom * denom
    d_pg = ((0.5 * V2 - X) * d_ro
            - (vx * du_mx + vy * du_my + vz * du_mz)
            + du_e - (by * d_by + bz * d_bz)) * (g - 1.0)

    # wave speeds (reference: Roe_get_wavespeeds:473-560)
    b2 = B * B / rho
    a2 = (2.0 - g) * X + (g - 1.0) * jnp.maximum(H - 0.5 * V2 - b2,
                                                 1.0e-12 * V2 + _TINY)
    a = jnp.sqrt(a2)
    astar2 = a2 + b2
    ca = jnp.sqrt(bx * bx / rho)
    disc = jnp.sqrt(jnp.maximum(astar2 * astar2 - 4.0 * a2 * ca * ca, 0.0))
    cf = jnp.sqrt(0.5 * (astar2 + disc))
    cs = jnp.sqrt(0.5 * jnp.maximum(astar2 - disc, 0.0))
    ca = jnp.minimum(ca, cf)
    cs = jnp.minimum(cs, ca)
    cf2_cs2 = cf * cf - cs * cs
    safe = cf2_cs2 > 1.0e-300
    denom_a = jnp.where(safe, cf2_cs2, 1.0)
    alphaf = jnp.sqrt(jnp.clip(jnp.maximum(a2 - cs * cs, 0.0) / denom_a,
                               0.0, 1.0))
    alphas = jnp.sqrt(jnp.clip(jnp.maximum(cf * cf - a2, 0.0) / denom_a,
                               0.0, 1.0))
    alphaf = jnp.where(safe, alphaf, 1.0 / jnp.sqrt(2.0))
    alphas = jnp.where(safe, alphas, 1.0 / jnp.sqrt(2.0))

    # eigenvalues with H-correction floors (reference:
    # Roe_get_eigenvalues:563-612)
    lam = [vx - cf, vx - ca, vx - cs, vx, vx + cs, vx + ca, vx + cf]
    if hc_eta is not None:
        lam = [jnp.where(e < 0.0, jnp.minimum(e, -hc_eta),
                         jnp.maximum(e, hc_eta)) for e in lam]

    # wave strengths (reference: Roe_get_wavestrengths:615-670)
    dv_t = bty * d_vy + btz * d_vz
    db_t = bty * d_by + btz * d_bz
    base = X * d_ro + d_pg
    s_fn = 0.5 * (alphaf * base + rho * alphas * cs * sgn_bx * dv_t
                  - rho * alphaf * cf * d_vx + sqrt_rho * alphas * a * db_t)
    s_fp = 0.5 * (alphaf * base - rho * alphas * cs * sgn_bx * dv_t
                  + rho * alphaf * cf * d_vx + sqrt_rho * alphas * a * db_t)
    s_sn = 0.5 * (alphas * base - rho * alphaf * cf * sgn_bx * dv_t
                  - rho * alphas * cs * d_vx - sqrt_rho * alphaf * a * db_t)
    s_sp = 0.5 * (alphas * base + rho * alphaf * cf * sgn_bx * dv_t
                  + rho * alphas * cs * d_vx - sqrt_rho * alphaf * a * db_t)
    s_an = 0.5 * (bty * d_vz - btz * d_vy
                  + sgn_bx * (bty * d_bz - btz * d_by) / sqrt_rho)
    s_ap = 0.5 * (-bty * d_vz + btz * d_vy
                  + sgn_bx * (bty * d_bz - btz * d_by) / sqrt_rho)
    s_ct = (a2 - X) * d_ro - d_pg

    # right eigenvectors in conserved variables, slots
    # (rho, mx, my, mz, by, bz, E) (reference: Roe_get_right_evectors:699-830)
    inv_a2 = 1.0 / a2
    rho_as = rho * alphas
    rho_af = rho * alphaf
    HB = H - B * B / rho
    vdotbt = vy * bty + vz * btz

    ev_ct = (1.0, vx, vy, vz, 0.0 * vx, 0.0 * vx,
             0.5 * V2 + X * (g - 2.0) / (g - 1.0))
    ev_ct = tuple(c * inv_a2 for c in ev_ct)
    ev_an = (0.0 * vx, 0.0 * vx, -rho * btz, rho * bty,
             -sgn_bx * sqrt_rho * btz, sgn_bx * sqrt_rho * bty,
             -rho * (vy * btz - vz * bty))
    ev_ap = (0.0 * vx, 0.0 * vx, rho * btz, -rho * bty,
             -sgn_bx * sqrt_rho * btz, sgn_bx * sqrt_rho * bty,
             rho * (vy * btz - vz * bty))
    norm = 1.0 / (rho * a2)
    ev_sn = tuple(c * norm for c in (
        rho_as, rho_as * (vx - cs),
        rho_as * vy - rho_af * cf * bty * sgn_bx,
        rho_as * vz - rho_af * cf * btz * sgn_bx,
        -sqrt_rho * alphaf * a * bty, -sqrt_rho * alphaf * a * btz,
        rho_as * (HB - vx * cs) - rho_af * cf * sgn_bx * vdotbt
        - sqrt_rho * alphaf * a * Bt))
    ev_sp = tuple(c * norm for c in (
        rho_as, rho_as * (vx + cs),
        rho_as * vy + rho_af * cf * bty * sgn_bx,
        rho_as * vz + rho_af * cf * btz * sgn_bx,
        -sqrt_rho * alphaf * a * bty, -sqrt_rho * alphaf * a * btz,
        rho_as * (HB + vx * cs) + rho_af * cf * sgn_bx * vdotbt
        - sqrt_rho * alphaf * a * Bt))
    ev_fn = tuple(c * norm for c in (
        rho_af, rho_af * (vx - cf),
        rho_af * vy + rho_as * cs * bty * sgn_bx,
        rho_af * vz + rho_as * cs * btz * sgn_bx,
        sqrt_rho * alphas * a * bty, sqrt_rho * alphas * a * btz,
        rho_af * (HB - vx * cf) + rho_as * cs * sgn_bx * vdotbt
        + sqrt_rho * alphas * a * Bt))
    ev_fp = tuple(c * norm for c in (
        rho_af, rho_af * (vx + cf),
        rho_af * vy - rho_as * cs * bty * sgn_bx,
        rho_af * vz - rho_as * cs * btz * sgn_bx,
        sqrt_rho * alphas * a * bty, sqrt_rho * alphas * a * btz,
        rho_af * (HB + vx * cf) - rho_as * cs * sgn_bx * vdotbt
        + sqrt_rho * alphas * a * Bt))

    waves = [(s_fn, lam[0], ev_fn), (s_an, lam[1], ev_an),
             (s_sn, lam[2], ev_sn), (s_ct, lam[3], ev_ct),
             (s_sp, lam[4], ev_sp), (s_ap, lam[5], ev_ap),
             (s_fp, lam[6], ev_fp)]

    fl = flux_from_prim(Pl, cfg)
    fr = flux_from_prim(Pr, cfg)
    f = fl + fr
    # dissipation: slots (rho->RO, mx..mz->VX..VZ, by,bz->BY,BZ, E->PG)
    for s, e, k in waves:
        c = s * jnp.abs(e)
        f = f.at[RO].add(-c * k[0])
        f = f.at[VX].add(-c * k[1])
        f = f.at[VY].add(-c * k[2])
        f = f.at[VZ].add(-c * k[3])
        f = f.at[BY].add(-c * k[4])
        f = f.at[BZ].add(-c * k[5])
        f = f.at[PG].add(-c * k[6])
    f = 0.5 * f

    # interface state from the Roe mean (reference:
    # set_pstar_from_meanp:299-345): p_g = rho*a^2/gamma
    nvar = Pl.shape[0]
    pad = [jnp.zeros_like(rho)] * (nvar - 8)
    pstar_p = jnp.stack([rho, rho * a2 / g, vx, vy, vz,
                         jnp.ones_like(rho) * bx, by, bz] + pad)
    return f, prim_to_cons(pstar_p, cfg)
