"""Cooling-only and simplified heating/cooling chemistry modules.

- :class:`MPOnlyCooling`: heating/cooling with no species tracking
  (reference: source/microphysics/mp_only_cooling.cpp; curve menu incl.
  SD93-CIE — cooling_SD93_cie.cpp:87-200 data reproduced below, the
  Sutherland & Dopita 1993 CIE curve, published data).
- :class:`MPv8`: the StarBench-workshop simplified prescription
  (reference: source/microphysics/MPv8.cpp: monochromatic/multifreq
  photoionization with heating tied to two equilibrium temperatures and the
  analytic Koyama-Inutsuka-style cooling Lambda(T)).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import jax.numpy as jnp

from ..config import SimConfig
from ..constants import K_B, M_P, PG, RO
from .base import JitCachedMP
from .mpv3 import MIN_NEUTRAL, SIGMA0, E_MONO, _interp1
from . import tables as TB

# Sutherland & Dopita (1993) solar-abundance CIE cooling curve
# (reference: cooling_SD93_cie.cpp:87-200; log-spaced 10^4..10^8.5 K).
_SD93_LOGT = np.linspace(4.0, np.log10(3.162278e8), 91)
_SD93_L = np.array([
    8.709636e-24, 3.467369e-23, 6.760830e-23, 1.202264e-22, 1.621810e-22,
    1.584893e-22, 1.380384e-22, 1.258925e-22, 1.318257e-22, 1.513561e-22,
    1.862087e-22, 2.344229e-22, 2.951209e-22, 3.801894e-22, 4.786301e-22,
    6.025596e-22, 7.244360e-22, 8.511380e-22, 9.772372e-22, 1.047129e-21,
    1.023293e-21, 9.549926e-22, 9.332543e-22, 9.772372e-22, 1.047129e-21,
    1.071519e-21, 1.096478e-21, 1.096478e-21, 1.023293e-21, 7.413102e-22,
    4.466836e-22, 2.818383e-22, 2.187762e-22, 1.949845e-22, 1.949845e-22,
    1.949845e-22, 1.737801e-22, 1.380384e-22, 1.174898e-22, 1.122018e-22,
    1.096478e-22, 1.096478e-22, 1.096478e-22, 1.122018e-22, 1.148154e-22,
    1.071519e-22, 8.511380e-23, 6.309573e-23, 4.897788e-23, 4.073803e-23,
    3.630781e-23, 3.311311e-23, 3.162278e-23, 2.951209e-23, 2.754229e-23,
    2.570396e-23, 2.511886e-23, 2.511886e-23, 2.570396e-23, 2.691535e-23,
    2.691535e-23, 2.570396e-23, 2.398833e-23, 2.238721e-23, 2.089296e-23,
    1.995262e-23, 1.905461e-23, 1.862087e-23, 1.862087e-23, 1.862087e-23,
    1.862087e-23, 1.905461e-23, 1.949845e-23, 1.995262e-23, 2.089296e-23,
    2.137962e-23, 2.238721e-23, 2.290868e-23, 2.398833e-23, 2.511886e-23,
    2.630268e-23, 2.754229e-23, 2.884032e-23, 2.951209e-23, 3.090295e-23,
    3.235937e-23, 3.388442e-23, 3.548134e-23, 3.715352e-23, 3.981072e-23,
    4.168694e-23,
])


def cooling_rate_sd93_cie(T):
    """Lambda(T) [erg cm^3/s], log-linear interp with MinSlope=8 cutoff
    below 10^4 K like the reference (:152)."""
    lT = np.log10(np.asarray(T, dtype=float))
    lL = np.log10(_SD93_L)
    spl = TB.CubicSpline(_SD93_LOGT, lL)
    lo, hi = _SD93_LOGT[0], _SD93_LOGT[-1]
    slope_hi = (lL[-1] - lL[-2]) / (_SD93_LOGT[-1] - _SD93_LOGT[-2])
    mid = spl(np.clip(lT, lo, hi))
    out = np.where(lT < lo, lL[0] + 8.0 * (lT - lo), mid)
    out = np.where(lT > hi, lL[-1] + slope_hi * (lT - hi), out)
    return 10.0 ** out


def lambda_starbench(T):
    """StarBench analytic cooling function (reference: MPv8.cpp:90,360)."""
    return 2.0e-19 * jnp.exp(-1.184e5 / (T + 1.0e3)) + \
        2.8e-28 * jnp.sqrt(T) * jnp.exp(-92.0 / T)


def cooling_rate_ki02(T):
    """Koyama & Inutsuka (2002) eq.4 cooling (with the Vazquez-Semadeni+07
    typo corrections the reference applies; reference: cooling.cpp:379-397)."""
    return (2.0e-19 * np.exp(-1.184e5 / (T + 1.0e3))
            + 2.8e-28 * np.sqrt(T) * np.exp(-92.0 / T))


# curve names follow the reference enum (reference: mp_only_cooling.h /
# mp_only_cooling.cpp:383-411 Edot switch)
COOLING_CURVES = ("KI02", "SD93_CIE", "SD93_PLUS_HEATING",
                  "WSS09_CIE_ONLY_COOLING", "WSS09_CIE_PLUS_HEATING",
                  "WSS09_CIE_LINE_HEAT_COOL")


@dataclasses.dataclass(frozen=True)
class CoolingConfig:
    gamma: float = 5.0 / 3.0
    helium_mass_frac: float = 0.2703
    min_temperature: float = 10.0
    max_temperature: float = 1.0e9
    mu: float = 0.61 * 1.0              # mean molecular weight (ionised)
    # which Edot function (reference cooling_flag; the reference recommends
    # WSS09_CIE_LINE_HEAT_COOL, mp_only_cooling.h:11-18)
    curve: str = "SD93_CIE"


class MPOnlyCooling(JitCachedMP):
    """Optically-thin heating/cooling, no species tracking
    (reference: mp_only_cooling.cpp; assumes fully-ionized solar gas with
    Mu=1.40 m_p, Mu_elec=1.167 m_p, Mu_ion=1.273 m_p —
    mp_only_cooling.cpp:81-87).

    Six selectable Edot functions (reference :383-411); all are tabulated
    per-component on a log-T grid and combined at runtime from number
    densities (never rho^2 ~ 1e-48, which is f32-subnormal)."""

    name = "mp_only_cooling"

    MU = 1.40 * M_P
    MU_ELEC = 1.167 * M_P
    MU_ION = 1.273 * M_P

    def __init__(self, mpc: CoolingConfig):
        assert mpc.curve in COOLING_CURVES, mpc.curve
        self.mpc = mpc
        # dense per-component lookups (reference: gen_mpoc_lookup_tables,
        # mp_only_cooling.cpp:525-560)
        Tg = np.logspace(np.log10(mpc.min_temperature),
                         np.log10(mpc.max_temperature), 300)
        self.Tg = jnp.asarray(Tg)
        tabs = {
            "sd93": cooling_rate_sd93_cie(Tg),
            "ki02": cooling_rate_ki02(Tg),
            "heat": 2.733e-21 * np.exp(-0.782991 * np.log(Tg)),
            "rrhp": TB.hii_rad_recomb_rate(Tg),
            "C_rrh": TB.hii_total_cooling(Tg),
            "C_ffhe": 6.72e-28 * np.sqrt(Tg),
            "C_fbdn": (1.20e-22 * np.exp(-33610.0 / Tg - (2180.0 / Tg) ** 2)
                       * np.exp(-Tg * Tg / 5.0e10)),
        }
        self.tab = {k: jnp.asarray(v) for k, v in tabs.items()}
        # stacked hot-loop lookup (same scheme as mpv3._t1_lookup): the
        # grid is log-uniform, so the bin index is arithmetic, and one
        # pair of row gathers serves every curve
        self._names = tuple(tabs)
        stack = np.stack([Tg] + [np.asarray(tabs[k]) for k in self._names],
                         axis=-1)
        self._stack = jnp.asarray(stack)
        self._lt0 = float(np.log10(Tg[0]))
        self._inv_dlt = float((len(Tg) - 1)
                              / (np.log10(Tg[-1]) - np.log10(Tg[0])))
        self._nt = len(Tg)

    def _nT(self, P):
        mu_mass = self.mpc.mu * M_P
        n = P[RO] / mu_mass
        T = P[PG] / P[RO] * (mu_mass / K_B)
        return n, T

    def temperature(self, P, cfg: SimConfig):
        return self._nT(P)[1]

    def set_temp(self, P, T, cfg: SimConfig):
        n, _ = self._nT(P)
        return P.at[PG].set(n * K_B * T)

    # -- the Edot menu (reference: mp_only_cooling.cpp:383-520) -------------
    def edot(self, rho, T):
        """Net heating-cooling rate [erg/cm^3/s] for the configured curve."""
        Tc = jnp.clip(T, self.mpc.min_temperature, self.mpc.max_temperature)
        fi = (jnp.log10(Tc) - self._lt0) * self._inv_dlt
        i = jnp.clip(fi.astype(jnp.int32), 0, self._nt - 2)
        lo = self._stack[i]
        hi = self._stack[i + 1]
        w = ((Tc - lo[..., 0]) / (hi[..., 0] - lo[..., 0]))[..., None]
        vals = lo[..., 1:] + w * (hi[..., 1:] - lo[..., 1:])
        _cols = {nm: vals[..., k] for k, nm in enumerate(self._names)}

        def f(name):
            return _cols[name]

        ne = rho / self.MU_ELEC
        ni = rho / self.MU_ION
        nmu = rho / self.MU
        cv = self.mpc.curve
        if cv == "KI02":
            return 2.0e-26 * nmu - nmu * nmu * f("ki02")
        if cv == "SD93_CIE":
            return -ne * ni * f("sd93")
        if cv == "SD93_PLUS_HEATING":
            return ne * nmu * f("heat") - ne * ni * f("sd93")
        if cv == "WSS09_CIE_ONLY_COOLING":
            # (reference :545-552: KI02-style 2e-26 n heating + CIE cooling)
            return 2.0e-26 * nmu - nmu * nmu * f("sd93")
        if cv == "WSS09_CIE_PLUS_HEATING":
            return ne * nmu * f("heat") - nmu * nmu * f("sd93")
        # WSS09_CIE_LINE_HEAT_COOL (recommended upstream): strongest of the
        # Henney+09 forbidden-line and CIE rates, plus H recomb/Brems cooling,
        # He Brems, and 5 eV/recombination photoheating (reference :489-520)
        rate = jnp.minimum(-f("C_fbdn") * ne * nmu,
                           -f("sd93") * nmu * nmu)
        rate = rate - f("C_rrh") * ne * nmu
        rate = rate - f("C_ffhe") * ne * nmu
        rate = rate + 8.01e-12 * f("rrhp") * ne * nmu
        return rate

    def _update_impl(self, P, dt, cfg: SimConfig, rt: Dict):
        mpc = self.mpc
        n, _ = self._nT(P)
        E = P[PG] / (mpc.gamma - 1.0)
        # sub-cycled semi-implicit update: cooling damped implicitly
        # E' = E/(1+h|Edot|/E), heating explicit (both A-stable here)
        h = dt / 8.0
        for _ in range(8):
            T = E * (mpc.gamma - 1.0) / (n * K_B)
            ed = self.edot(P[RO], T)
            E = jnp.where(ed >= 0.0, E + h * ed, E / (1.0 - h * ed / E))
        E_floor = n * K_B * mpc.min_temperature / (mpc.gamma - 1.0)
        E_ceil = n * K_B * mpc.max_temperature / (mpc.gamma - 1.0)
        E = jnp.clip(E, E_floor, E_ceil)
        return P.at[PG].set(E * (mpc.gamma - 1.0))

    def default_rt(self, P):
        return {}

    dt_limit_processes = ("cooling",)  # reference: mp_only_cooling.cpp:333

    def cell_timescales(self, P, cfg: SimConfig, rt: Dict):
        """Cooling time = Eint / max(|Edot(T)|, |Edot(max(Tmin, T/2))|),
        skipped near the temperature floor (reference:
        mp_only_cooling.cpp:333-368 — no extra safety factor)."""
        mpc = self.mpc
        n, T = self._nT(P)
        E = P[PG] / (mpc.gamma - 1.0)
        ed = jnp.maximum(
            jnp.abs(self.edot(P[RO], T)),
            jnp.abs(self.edot(P[RO],
                              jnp.maximum(mpc.min_temperature, 0.5 * T))))
        t_cool = E / (ed + 1e-100)
        return jnp.where(T >= 1.1 * mpc.min_temperature, t_cool, 1.0e99)


@dataclasses.dataclass(frozen=True)
class MPv8Config:
    tracer_slot: int
    gamma: float = 5.0 / 3.0
    helium_mass_frac: float = 0.2703
    metal_mass_frac: float = 0.0142     # >0.5 => neutral medium is molecular
    min_temperature: float = 10.0
    max_temperature: float = 1.0e4
    ion_src: Optional[str] = "mono"
    n_idot: float = 0.0

    @property
    def x_frac(self):
        return 1.0 - self.helium_mass_frac

    @property
    def mean_mass_per_h(self):
        return M_P / self.x_frac

    @property
    def mol(self):
        return 0.5 if self.metal_mass_frac > 0.5 else 1.0


class MPv8(JitCachedMP):
    """StarBench simplified photoionization + heating/cooling
    (reference: MPv8.cpp:228-360)."""

    name = "MPv8"
    ALPHA = 2.7e-13

    def __init__(self, mpc: MPv8Config):
        self.mpc = mpc
        T = mpc.max_temperature
        self.eeq_hi = float(2.0e-19 * np.exp(-1.184e5 / (T + 1.0e3))
                            + 2.8e-28 * np.sqrt(T) * np.exp(-92.0 / T))
        T = mpc.min_temperature
        self.eeq_lo = float(2.0e-19 * np.exp(-1.184e5 / (T + 1.0e3))
                            + 2.8e-28 * np.sqrt(T) * np.exp(-92.0 / T))

    def n_H(self, rho):
        return rho / (M_P / self.mpc.x_frac)

    def n_tot(self, nH, x):
        c = self.mpc
        nnt = c.mol + 0.25 * c.helium_mass_frac / c.x_frac
        return ((1.0 - x) * c.mol + (nnt - c.mol) + x * 2.0) * nH

    def temperature(self, P, cfg: SimConfig):
        nH = self.n_H(P[RO])
        x = P[self.mpc.tracer_slot]
        return P[PG] / (K_B * self.n_tot(nH, x))

    def set_temp(self, P, T, cfg: SimConfig):
        nH = self.n_H(P[RO])
        x = P[self.mpc.tracer_slot]
        return P.at[PG].set(self.n_tot(nH, x) * K_B * T)

    def ydot(self, omx, Eint, nH, rt):
        c = self.mpc
        x = 1.0 - omx
        ne = x * nH
        T = (c.gamma - 1.0) * Eint / (K_B * self.n_tot(nH, x))
        T = jnp.clip(T, 1.0, 1.0e9)
        omx_dot = jnp.zeros_like(omx)
        Edot = jnp.zeros_like(Eint)
        if c.ion_src == "mono":
            frac = float(TB.hi_xsection_fractional(E_MONO))
            dtau = nH * rt["ds"] * omx * SIGMA0 * frac
            nv = rt.get("nv", None)
            if nv is None:
                nv = rt["n_idot"] / rt["vshell"]
            rate = nv * jnp.exp(-rt["tau0"] * frac)
            rate = rate * jnp.where(dtau < 1e-4, dtau, 1.0 - jnp.exp(-dtau)) / nH
            omx_dot -= rate
            Edot += rate * self.eeq_hi / self.ALPHA
        omx_dot += self.ALPHA * x * ne
        Edot -= nH * lambda_starbench(T)
        Edot += nH * self.eeq_lo * c.min_temperature / T
        Edot *= nH
        return omx_dot, Edot

    def _update_impl(self, P, dt, cfg: SimConfig, rt: Dict):
        c = self.mpc
        nH = self.n_H(P[RO])
        E = P[PG] / (c.gamma - 1.0)
        omx = jnp.clip(1.0 - P[c.tracer_slot], MIN_NEUTRAL, 1.0 - MIN_NEUTRAL)
        # 16 implicit-ish substeps (midpoint-evaluated explicit, bounded)
        h = dt / 16.0
        for _ in range(16):
            d_omx, d_E = self.ydot(omx, E, nH, rt)
            omx = jnp.clip(omx + h * d_omx, MIN_NEUTRAL, 1.0 - MIN_NEUTRAL)
            E = jnp.maximum(E + h * d_E, 0.01 * E)
        x = 1.0 - omx
        T = (c.gamma - 1.0) * E / (K_B * self.n_tot(nH, x))
        ntot = self.n_tot(nH, x)
        E = jnp.where(T > 1.5 * c.max_temperature,
                      ntot * K_B * 1.5 * c.max_temperature / (c.gamma - 1.0), E)
        E = jnp.where(T < c.min_temperature,
                      ntot * K_B * c.min_temperature / (c.gamma - 1.0), E)
        out = P.at[PG].set(E * (c.gamma - 1.0))
        return out.at[c.tracer_slot].set(x)

    def cell_timescales(self, P, cfg: SimConfig, rt: Dict):
        c = self.mpc
        nH = self.n_H(P[RO])
        E = P[PG] / (c.gamma - 1.0)
        omx = jnp.clip(1.0 - P[c.tracer_slot], MIN_NEUTRAL, 1.0 - MIN_NEUTRAL)
        d_omx, d_E = self.ydot(omx, E, nH, rt)
        t = 0.25 / (jnp.abs(d_omx) + 1e-100)
        return jnp.minimum(t, 0.25 * E / (jnp.abs(d_E) + 1e-100))

    def default_rt(self, P) -> Dict:
        z = jnp.zeros_like(P[RO])
        return {"tau0": z + 1.0e6, "ds": z, "vshell": z + 1.0e30,
                "n_idot": self.mpc.n_idot, "nv": z, "sv": z}
