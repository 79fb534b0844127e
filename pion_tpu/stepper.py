"""Time integration: OA1 / OA2 predictor-corrector updates.

JAX re-derivation of the reference time integrator
(reference: source/sim_control/time_integrator.cpp:70-243 ``advance_time``,
``first_order_update``, ``second_order_update``, and :881-960
``grid_update_state_vector``).  The reference's two per-cell state vectors
``P`` (start-of-step) and ``Ph`` (half-step) become two dense arrays; one
whole ``advance`` is a single pure function under ``jax.jit``.

Scheme (OA2): Ph = P + (dt/2)*dU[Ph, 1st-order space];
              P' = P + dt*dU[Ph, 2nd-order space].
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .boundaries import BoundaryData, apply_bcs
from .config import SimConfig


def _scma_flag(physics):
    """sCMA sweep flag: element-slot tuple when the module declares
    element tracers, plain True when a module owns the tracers at all."""
    if physics is None or physics.mp is None:
        return False
    el = tuple(getattr(physics.mp, "element_slots", ()) or ())
    return el if el else True
from .constants import SI, Eqn
from .device import HoistedJit
from .grid import Geometry
from .ops.eqns import cons_to_prim, prim_to_cons
from .ops.sweep import dynamics_dU
from .ops.timestep import dynamics_dt


def cell_advance(P, dU, cfg: SimConfig):
    """U(P) + dU -> primitive, with floor recovery inside cons_to_prim
    (reference: solver_eqn_hydro_adi.cpp:372-448 CellAdvanceTime)."""
    U = prim_to_cons(P, cfg) + dU
    return cons_to_prim(U, cfg)


def glm_psi_damp(P, dt, ch, cfg: SimConfig, geom: Geometry):
    """Parabolic damping psi *= exp(-dt*c_h*c_r), c_r = 0.25/dx
    (reference: eqns_mhd_adiabatic.cpp:651-660 GLMsource;
    calc_timestep.cpp:128-137 sets cr)."""
    cr = cfg.glm_cr_factor / geom.dx
    return P.at[SI].multiply(jnp.exp(-dt * ch * cr))


def _partial_update(P, Ph, dt, order_space, cfg, geom, bdata, ch,
                    physics=None, t=0.0, rt=None, sp=None):
    """One flux update: dU from Ph, applied on top of P.

    Chemistry contributes a conserved increment computed from P with columns
    traced through Ph (reference: time_integrator.cpp:151-197, 206-243 —
    RT_all_sources -> calc_microphysics_dU -> calc_dynamics_dU).
    Returns the advanced primitive state (the reference writes it into Ph,
    then copies to P on the final step)."""
    Ppad = apply_bcs(Ph, cfg, bdata, t=t)
    dU, _faces = dynamics_dU(Ppad, cfg, geom, dt, order_space, ch=ch,
                             scma=(physics is not None
                                   and physics.mp is not None))
    if physics is not None and physics.mp is not None:
        dU = dU + physics.mp_delta_U(P, Ph, dt, cfg, rt=rt, sp=sp)
    if cfg.conduction:
        from .constants import K_B, M_P, RO as _RO, PG as _PG
        from .ops.conduction import conduction_Edot

        if physics is not None and physics.mp is not None:
            Tpad = physics.mp.temperature(Ppad, cfg)
        else:
            # grouped (p/rho)*(m_p/k_B): rho*k_B ~ 1e-42 cgs is below the
            # f32 normal range
            Tpad = Ppad[_PG] / Ppad[_RO] * (M_P / K_B)
        dU = dU.at[_PG].add(dt * conduction_Edot(Ppad, Tpad, cfg, geom))
    Pnew = cell_advance(P, dU, cfg)
    if cfg.eqn is Eqn.GLM:
        Pnew = glm_psi_damp(Pnew, dt, ch, cfg, geom)
    if physics is not None:
        if physics.mp is not None:
            # temperature clamps (reference: grid_update_state_vector:914-920)
            T = physics.mp.temperature(Pnew, cfg)
            Pnew = jnp.where(
                T > cfg.max_temperature,
                physics.mp.set_temp(Pnew, cfg.max_temperature, cfg), Pnew)
        Pnew = physics.apply_internal_bcs(Pnew, t + dt)
    return Pnew


def advance(P, dt, cfg: SimConfig, geom: Geometry,
            bdata: Optional[BoundaryData] = None, ch=None, physics=None,
            t=0.0, rt0=None, sp=None):
    """Advance one full step of size dt; returns the new state.

    OA1: single 1st-order update (reference: time_integrator.cpp:80-97).
    OA2: half-step predictor (1st-order space) then full corrector
    (2nd-order space) (reference: time_integrator.cpp:99-124).
    ``rt0``: radiation columns already traced through P (the predictor's
    Ph), e.g. shared with the dt computation in the fused step.
    """
    if cfg.eqn is Eqn.GLM and ch is None:
        ch = cfg.cfl * geom.dx / dt
    if cfg.ooa == 1:
        return _partial_update(P, P, dt, 1, cfg, geom, bdata, ch, physics, t,
                               rt=rt0, sp=sp)
    Ph = _partial_update(P, P, 0.5 * dt, 1, cfg, geom, bdata, ch, physics, t,
                         rt=rt0, sp=sp)
    return _partial_update(P, Ph, dt, 2, cfg, geom, bdata, ch, physics, t,
                           sp=sp)


class StepFns(NamedTuple):
    advance: callable   # (P, dt) -> P_new
    calc_dt: callable   # (P,) -> scalar dynamical dt
    step: callable      # (P, t, last_dt, dt_cap) -> (P_new, dt, dt_raw)
    multi_step: callable = None
    # (P, t, last_dt, t_target, sp, K) -> (P_new, dts[K], dt_raws[K]):
    # K fused steps in ONE dispatch (lax.scan) — the dt policy runs
    # in-graph, steps past t_target become identity


def make_step_fns(cfg: SimConfig, geom: Geometry,
                  bdata: Optional[BoundaryData] = None,
                  physics=None) -> StepFns:
    """Build jitted advance/dt functions with config closed over."""

    def _dt_expr(P, rt0=None):
        excl = (physics.wind_exclude_mask()
                if physics is not None and physics.winds else None)
        dt = dynamics_dt(P, cfg, geom, exclude=excl)
        if physics is not None and physics.dt_limit and physics.mp is not None:
            # chemistry/cooling dt limit (reference: calc_timestep.cpp:342
            # calc_microphysics_dt with MP_timestep_limit)
            dt = jnp.minimum(dt, physics.timescale(P, cfg, rt=rt0))
        if cfg.conduction:
            from .constants import K_B, M_P, RO as _RO, PG as _PG
            from .ops.conduction import conduction_Edot, conduction_dt

            Ppad = apply_bcs(P, cfg, bdata)
            if physics is not None and physics.mp is not None:
                Tpad = physics.mp.temperature(Ppad, cfg)
            else:
                Tpad = Ppad[_PG] / Ppad[_RO] * (M_P / K_B)
            Edot = conduction_Edot(Ppad, Tpad, cfg, geom)
            dt = jnp.minimum(dt, conduction_dt(P, Edot, cfg))
        return dt

    @HoistedJit
    def _advance(P, dt, t=0.0, sp=None):
        return advance(P, dt, cfg, geom, bdata, physics=physics, t=t, sp=sp)

    @HoistedJit
    def _calc_dt(P):
        return _dt_expr(P)

    @HoistedJit
    def _step(P, t, last_dt, dt_cap, sp=None):
        """Fused dt + advance: ONE compiled program per step, and the
        radiation columns through P are traced ONCE and shared between the
        chemistry dt limit and the predictor partial update (the reference
        also raytraces once per partial update, not once per consumer —
        time_integrator.cpp:206-243).  dt clamps follow the reference's
        timestep_checking_and_limiting (calc_timestep.cpp:219-260): growth
        limit, then the caller-supplied cap (next output time / finish
        time)."""
        rt0 = None
        if (physics is not None and physics.sources
                and physics.mp is not None):
            rt0 = physics.raytrace(P, sp=sp)
        dt_raw = _dt_expr(P, rt0)
        dt = jnp.where(last_dt > 0.0,
                       jnp.minimum(dt_raw, cfg.max_dt_growth * last_dt),
                       dt_raw)
        dt = jnp.minimum(dt, dt_cap)
        Pn = advance(P, dt, cfg, geom, bdata, physics=physics, t=t,
                     rt0=rt0, sp=sp)
        return Pn, dt, dt_raw

    _multi_cache = {}

    def _multi_step(P, t, last_dt, t_target, sp=None, K=16):
        """K fused dt+advance steps in ONE compiled dispatch.

        Removes the per-step dispatch overhead that dominates small grids
        (the reference pays none).  Each in-graph step applies the
        full dt policy with the cap tmax_target - t; once t reaches the
        target, dt clamps to 0 and the state passes through unchanged.
        Returns (P, dts, dt_raws) — the host advances its clock/step
        count from the returned dt array (dt > 0 entries)."""
        if K not in _multi_cache:
            @HoistedJit
            def _runK(P, t, last_dt, t_target, sp=None):
                def body(carry, _):
                    Pc, tc, ldt = carry
                    rt0 = None
                    if (physics is not None and physics.sources
                            and physics.mp is not None):
                        rt0 = physics.raytrace(Pc, sp=sp)
                    dt_raw = _dt_expr(Pc, rt0)
                    dt = jnp.where(ldt > 0.0,
                                   jnp.minimum(dt_raw,
                                               cfg.max_dt_growth * ldt),
                                   dt_raw)
                    dt = jnp.minimum(dt, t_target - tc)
                    live = dt > 0.0
                    dt_eff = jnp.maximum(dt, 0.0)
                    Pn = advance(Pc, jnp.where(live, dt_eff, 1.0), cfg,
                                 geom, bdata, physics=physics, t=tc,
                                 rt0=rt0, sp=sp)
                    Pn = jnp.where(live, Pn, Pc)
                    return ((Pn, tc + jnp.where(live, dt_eff, 0.0),
                             jnp.where(live, dt_eff, ldt)),
                            (jnp.where(live, dt_eff, 0.0), dt_raw))

                (Pn, tn, ldtn), (dts, dt_raws) = jax.lax.scan(
                    body, (P, t, last_dt), None, length=K)
                return Pn, dts, dt_raws

            _multi_cache[K] = _runK
        return _multi_cache[K](P, t, last_dt, t_target, sp)

    return StepFns(advance=_advance, calc_dt=_calc_dt, step=_step,
                   multi_step=_multi_step)
