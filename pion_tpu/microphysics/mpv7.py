"""MPv7: two-temperature isothermal photoionization module.

Reference: source/microphysics/MPv7.cpp — the gas temperature is a function
of ionization fraction only, T = T_lo + x*(T_hi - T_lo) (:235), so only the
ion fraction is integrated; pressure is slaved to T(x).  Used for simple
HII-region expansion tests (e.g. Iliev et al. 2006 test 5 analogues with
fixed temperatures).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax.numpy as jnp

from ..config import SimConfig
from ..constants import K_B, M_P, PG, RO
from . import tables as TB
from .base import JitCachedMP
from .mpv3 import MIN_NEUTRAL, SIGMA0, E_MONO


@dataclasses.dataclass(frozen=True)
class MPv7Config:
    tracer_slot: int
    gamma: float = 5.0 / 3.0
    helium_mass_frac: float = 0.2703
    metal_mass_frac: float = 0.0142     # >0.5 => molecular neutral medium
    t_lo: float = 1.0e2                 # neutral-gas temperature
    t_hi: float = 1.0e4                 # ionized-gas temperature
    ion_src: Optional[str] = "mono"
    n_idot: float = 0.0
    recomb_rate: float = 2.7e-13        # case-B at ~1e4 K (reference MPv7)

    @property
    def x_frac(self):
        return 1.0 - self.helium_mass_frac

    @property
    def mean_mass_per_h(self):
        return M_P / self.x_frac

    @property
    def mol(self):
        return 0.5 if self.metal_mass_frac > 0.5 else 1.0


class MPv7(JitCachedMP):
    name = "MPv7"

    def __init__(self, mpc: MPv7Config):
        self.mpc = mpc

    def n_H(self, rho):
        return rho / (M_P / self.mpc.x_frac)

    def n_tot(self, nH, x):
        c = self.mpc
        nnt = c.mol + 0.25 * c.helium_mass_frac / c.x_frac
        # (reference: MPv7.cpp get_ntot with JM_NELEC=JM_NION=1)
        return ((1.0 - x) * c.mol + (nnt - c.mol) + x * 2.0) * nH

    def t_of_x(self, x):
        return self.mpc.t_lo + x * (self.mpc.t_hi - self.mpc.t_lo)

    def temperature(self, P, cfg: SimConfig):
        return self.t_of_x(P[self.mpc.tracer_slot])

    def set_temp(self, P, T, cfg: SimConfig):
        # temperature is slaved to x; just reset pressure consistently
        nH = self.n_H(P[RO])
        x = P[self.mpc.tracer_slot]
        return P.at[PG].set(self.n_tot(nH, x) * K_B * self.t_of_x(x))

    def xdot(self, omx, nH, rt):
        c = self.mpc
        x = 1.0 - omx
        ne = x * nH
        omx_dot = c.recomb_rate * x * ne
        if c.ion_src == "mono":
            frac = float(TB.hi_xsection_fractional(E_MONO))
            entries = rt.get("ion")
            if entries is None:
                entries = (rt,)
            for e in entries:  # summed per-source columns (rad_src_data.h)
                dtau = nH * e["ds"] * omx * SIGMA0 * frac
                nv = e.get("nv", None)
                if nv is None:
                    nv = e["n_idot"] / e["vshell"]
                rate = nv * jnp.exp(-e["tau0"] * frac)
                rate = rate * jnp.where(dtau < 1e-4, dtau,
                                        1.0 - jnp.exp(-dtau)) / nH
                omx_dot = omx_dot - rate
        return omx_dot

    def _update_impl(self, P, dt, cfg: SimConfig, rt: Dict):
        """Backward-Euler with bound-limited scalar Newton per substep (the
        explicit form cannot equilibrate the stiff photoionization front)."""
        import jax

        c = self.mpc
        nH = self.n_H(P[RO])
        omx = jnp.clip(1.0 - P[c.tracer_slot], MIN_NEUTRAL, 1.0 - MIN_NEUTRAL)
        h = dt / 8.0
        for _ in range(8):
            prev = omx
            y = omx
            for _i in range(10):
                f, df = jax.jvp(lambda a: self.xdot(a, nH, rt), (y,),
                                (jnp.ones_like(y),))
                g = y - prev - h * f
                dg = 1.0 - h * df
                step = g / jnp.where(jnp.abs(dg) > 1e-300, dg, 1.0)
                step = jnp.clip(step, -0.25, 0.25)
                y = jnp.clip(y - step, MIN_NEUTRAL, 1.0 - MIN_NEUTRAL)
            omx = y
        x = 1.0 - omx
        out = P.at[c.tracer_slot].set(x)
        return out.at[PG].set(self.n_tot(nH, x) * K_B * self.t_of_x(x))

    def cell_timescales(self, P, cfg: SimConfig, rt: Dict):
        c = self.mpc
        nH = self.n_H(P[RO])
        omx = jnp.clip(1.0 - P[c.tracer_slot], MIN_NEUTRAL, 1.0 - MIN_NEUTRAL)
        d = self.xdot(omx, nH, rt)
        return 0.25 / (jnp.abs(d) + 1e-100)

    def default_rt(self, P) -> Dict:
        z = jnp.zeros_like(P[RO])
        return {"tau0": z + 1.0e6, "ds": z, "vshell": z + 1.0e30,
                "n_idot": self.mpc.n_idot, "nv": z, "sv": z}
