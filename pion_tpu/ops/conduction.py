"""Saturated thermal conduction (Slavin & Cox 1992).

JAX re-derivation of the reference's compile-flagged conduction
module (reference: source/spatial_solvers/solver_eqn_base.cpp:687-875
``set_thermal_conduction_Edot``; enabled by ``#define THERMAL_CONDUCTION``,
defines/functionality_flags.h:90; dt limit in
sim_control/calc_timestep.cpp:163-211 ``calc_conduction_dt_and_Edot``).

Per face between cells 1 and 2 along each axis:

  gradT      = (T2 - T1) / dx
  donor      = the upstream cell (2 if gradT > 0 else 1)
  ln(Lambda) = 29.7                          for T <= 4.2e5 K
             = 29.7 + ln(T / (1e6 sqrt(rho * 4.2735e23)))  otherwise
  Q_clas     = -1.84e-5 T^2.5 gradT / ln(Lambda)
  Q_sat      = -sign(gradT) 1.5 p^1.5 / sqrt(rho)     (phi_s = 0.3, S&C92)
  Q          = Q_sat (1 - exp(-Q_clas / Q_sat))

and Edot = -div(Q) with the coordinate-system face/volume factors
(the same div_cn/div_cp coefficients the flux divergence uses).

The reference walks columns cell-by-cell; here each axis is three dense
slices and the whole grid updates at once.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..config import SimConfig
from ..constants import PG, RO
from ..grid import Geometry


def conduction_Edot(Ppad, Tpad, cfg: SimConfig, geom: Geometry):
    """Energy-density rate dE/dt (erg/cm^3/s) on the interior cells.

    ``Ppad``: padded primitive state (nvar, *spatial+2ng);
    ``Tpad``: padded temperature (spatial+2ng).
    """
    nd = cfg.ndim
    ng = cfg.ng
    out = None
    for ax in range(nd):
        # window: one ghost layer along ax, interior on the other axes
        win = [slice(ng, -ng)] * nd
        win[ax] = slice(ng - 1, Tpad.shape[ax] - ng + 1)
        w = tuple(win)
        T = Tpad[w]
        rho = Ppad[(RO,) + w]
        pg = Ppad[(PG,) + w]

        def lo(A):
            s = [slice(None)] * nd
            s[ax] = slice(0, A.shape[ax] - 1)
            return A[tuple(s)]

        def hi(A):
            s = [slice(None)] * nd
            s[ax] = slice(1, A.shape[ax])
            return A[tuple(s)]

        gradT = (hi(T) - lo(T)) / geom.dx
        up = gradT > 0.0
        Td = jnp.where(up, hi(T), lo(T))
        rd = jnp.where(up, hi(rho), lo(rho))
        pd = jnp.where(up, hi(pg), lo(pg))
        lnL = jnp.where(
            Td <= 4.2e5, 29.7,
            29.7 + jnp.log(jnp.maximum(Td, 4.2e5)
                           / (1.0e6 * jnp.sqrt(rd * 4.2735e23))))
        q_clas = -1.84e-5 * Td**2.5 * gradT / lnL
        q_sat = -jnp.sign(gradT) * 1.5 * pd * jnp.sqrt(pd / rd)
        # Q = Qs (1 - exp(-Qc/Qs)): -> Qc when |Qc|<<|Qs|, -> Qs when >>.
        # Guard the 0/0 at gradT == 0 (both zero -> Q = 0).
        ratio = q_clas / jnp.where(q_sat == 0.0, 1.0, q_sat)
        Q = jnp.where(q_sat == 0.0, 0.0, q_sat * -jnp.expm1(-ratio))

        # divergence with the per-axis face/volume coefficients
        g = geom.axes[ax]
        shape = [1] * nd
        shape[ax] = -1
        cn = jnp.asarray(g.div_cn).reshape(shape)
        cp = jnp.asarray(g.div_cp).reshape(shape)
        contrib = cn * lo(Q) - cp * hi(Q)
        out = contrib if out is None else out + contrib
    return out


def conduction_dt(P, Edot, cfg: SimConfig):
    """Conduction timestep limit: 0.1 min(E_int/|Edot|) over cells with
    pressure above floor (reference: calc_timestep.cpp:188-210; the
    reference uses gm1*|Edot| i.e. internal energy, and multiplies 0.1)."""
    gm1 = cfg.gamma - 1.0
    ok = P[PG] > 1.0e-3 * cfg.p_ref
    tc = P[PG] / (gm1 * (jnp.abs(Edot) + 1.0e-100))
    return 0.1 * jnp.min(jnp.where(ok, tc, 1.0e200))
