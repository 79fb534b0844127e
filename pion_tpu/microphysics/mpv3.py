"""MPv3: non-equilibrium H photoionization + heating/cooling (the workhorse).

JAX re-derivation of the reference module
(reference: source/microphysics/MPv3.cpp).  The model integrates two ODEs per
cell — the neutral fraction (1-x) and internal energy density E — with:

  - multifrequency or monochromatic photoionization + photoheating
    (Frank & Mellema 1994 discretized rates, MPv3.cpp:1713-1761)
  - Voronov (1997) collisional ionization + cooling
  - Hummer (1994) case-B recombination + recombination/free-free cooling
  - collisional-excitation cooling of H0 (Aggarwal 1983)
  - forbidden-line, Wiersma+ (2009) CIE, CII/OI, PAH metal cooling and
    Wolfire+ (2003) PAH heating, cosmic-ray heating/ionization,
    Henney+ (2009) UV/IR heating  (MPv3.cpp:1786-1890)

Where the reference hands each cell to CVODE (BDF + Newton, one serial
N_Vector per cell — cvode_integrator.h:106-131), this module integrates ALL
cells at once: cells whose relative change is below EULER_CUTOFF take a
forward-Euler step (MPv3.cpp:1170-1180), the rest take fixed-count
backward-Euler Newton substeps — branch-free and fully vectorized.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SimConfig
from ..constants import K_B, M_P, PG, RO
from . import tables as TB
from .base import min_timescale

EULER_CUTOFF = 0.05     # reference: MPv3.h:90
MIN_NEUTRAL = 1.0e-20   # reference: MPv3.h:94 JM_MINNEU
DTFRAC = 0.25           # tier-2/6 fraction (reference: MPv3.cpp:188-224)


def dtlimit_tier_params(tier: int):
    """(dtfrac, energy_limit, relative_neufrac) for an MPV3_DTLIMIT tier
    (reference: MPv3.cpp:185-228)."""
    fracs5 = (1.0, 0.5, 0.25, 0.125, 0.0625)
    fracs4 = (0.5, 0.25, 0.125, 0.0625)
    if 0 <= tier <= 4:
        return fracs5[tier], False, False
    if 5 <= tier <= 8:
        return fracs4[tier - 5], True, False
    if 9 <= tier <= 12:
        return fracs4[tier - 9], True, True
    raise ValueError(f"MPV3_DTLIMIT tier {tier} not in 0..12 "
                     "(reference: MPv3.cpp:185-228)")
SIGMA0 = 6.3042e-18     # H0 photoionization cross-section at threshold
E_MONO = 2.98e-11       # 5 eV above threshold (reference: MPv3.cpp:1744)
E_EXCESS = 8.01e-12


@dataclasses.dataclass(frozen=True)
class MPv3Config:
    """Static chemistry configuration (reference: SimParams.EP + RS)."""

    tracer_slot: int                  # index of x(H+) in the primitive vector
    gamma: float = 5.0 / 3.0
    helium_mass_frac: float = 0.2703  # reference EP default
    metal_mass_frac: float = 0.0142
    min_temperature: float = 10.0
    max_temperature: float = 1.0e9
    # ionizing source: None | "mono" | "mfion"
    ion_src: Optional[str] = None
    n_idot: float = 0.0               # ionizing photon rate [1/s]
    tstar: float = 0.0                # blackbody T for mfion
    rstar_cm: float = 0.0             # stellar radius [cm] for mfion
    n_diff_srcs: int = 0              # UV-heating source count
    n_table: int = 200                # lookup-table resolution
    # MPV3_DTLIMIT tier (reference: MPv3.cpp:185-228 + defines/
    # functionality_flags.h:63): 0-4 = DTFRAC {1,.5,.25,.125,.0625} on
    # |xdot| only; 5-8 = + energy-change limit; 9-12 = + relative neutral
    # fraction.  Default 6 (DTFRAC=0.25 with the energy limit) — the
    # behavior this port has always had; the reference compiles tier 2.
    dtlimit_tier: int = 6

    @property
    def x_frac(self) -> float:
        return 1.0 - self.helium_mass_frac

    @property
    def mean_mass_per_h(self) -> float:
        return M_P / self.x_frac

    @property
    def n_ion(self) -> float:   # ions per H nucleon when ionised (JM_NION)
        return 1.0 + 0.25 * self.helium_mass_frac / self.x_frac

    @property
    def n_elec(self) -> float:  # electrons per ionised H (JM_NELEC)
        return 1.0 + 0.25 * self.helium_mass_frac / self.x_frac

    @property
    def metallicity(self) -> float:
        return self.metal_mass_frac / 0.0142


def _interp1(grid, tab, x):
    """Linear interpolation with linear extrapolation beyond ends
    (matches the reference's table + slope scheme, MPv3.cpp:1655-1676)."""
    i = jnp.clip(jnp.searchsorted(grid, x) - 1, 0, len(grid) - 2)
    s = (tab[i + 1] - tab[i]) / (grid[i + 1] - grid[i])
    return tab[i] + s * (x - grid[i])


def _interp2(tg, eg, tab, T, ne):
    """Plane interpolation on a 2D (T, ne) table (reference: MPv3.cpp:1817)."""
    i = jnp.clip(jnp.searchsorted(tg, T) - 1, 0, len(tg) - 2)
    j = jnp.clip(jnp.searchsorted(eg, ne) - 1, 0, len(eg) - 2)
    st = (tab[i + 1, j] - tab[i, j]) / (tg[i + 1] - tg[i])
    se = (tab[i, j + 1] - tab[i, j]) / (eg[j + 1] - eg[j])
    return tab[i, j] + st * (T - tg[i]) + se * (ne - eg[j])


class MPv3:
    """Vectorized MPv3 chemistry module."""

    name = "MPv3"

    def __init__(self, mpc: MPv3Config):
        self.mpc = mpc
        self._build_tables()
        self._update_jit = jax.jit(self._update_impl, static_argnames=("cfg",))
        self._timescales_jit = jax.jit(
            self._timescales_impl, static_argnames=("cfg",))

    # -- setup-time table construction (numpy; reference: MPv3.cpp:1945) ----
    def _build_tables(self):
        c = self.mpc
        NT = c.n_table
        Z = c.metallicity
        T = np.logspace(np.log10(c.min_temperature),
                        np.log10(c.max_temperature), NT)
        ne = np.logspace(-6.0, 6.0, NT)
        cir, cicr = TB.hi_coll_ion_rates(T)
        t = {
            "T": T, "ne": ne,
            "cirh": cir,                       # collisional ionization rate
            "C_cih0": cicr,                    # its cooling
            "rrhp": TB.hii_rad_recomb_rate(T),
            "C_rrh": TB.hii_total_cooling(T),
            "C_ffhe": 1.68e-27 * (c.n_ion - 1.0) * np.sqrt(T),
            "C_cxh0": TB.hi_coll_excitation_cooling_rate(T)
                      * np.exp(-T * T / 5.0e10),
            "C_fbdn": 1.20e-22 * Z
                      * np.exp(-33610.0 / T - (2180.0 / T) ** 2)
                      * np.exp(-T * T / 5.0e10),
            "C_cie": Z * TB.cooling_rate_wss09_metals(T),
            "C_cxch": 3.15e-27 * Z * np.exp(-92.0 / T),
            "C_cxo": 3.96e-28 * Z * np.exp(0.4 * np.log(T) - 228.0 / T),
        }
        TT, NE = np.meshgrid(T, ne, indexing="ij")
        t["H_pah"] = 1.083e-25 * Z / (1.0 + 9.77e-3 * (np.sqrt(TT) / NE) ** 0.73)
        t["C_pah"] = 3.02e-30 * Z * np.exp(
            0.94 * np.log(TT)
            + 0.74 * TT ** (-0.068) * np.log(3.4 * np.sqrt(TT) / NE)
        ) * NE
        t["C_cxce"] = (1.4e-23 * Z * np.exp(-0.5 * np.log(TT) - 92.0 / TT)
                       * NE / (1.0 + 0.05 * NE * (TT / 2000.0) ** (-0.37)))
        if c.ion_src == "mfion":
            pt = TB.build_photoion_tables(c.tstar, c.rstar_cm)
            # normalize the (log10) rate tables by their peak so runtime
            # exponentials stay in float32 range (raw rates ~1e47 overflow
            # f32); the peak is restored through rt["sv"] = 10^ls / Vshell,
            # a host-side f64 product that is itself f32-representable
            self.rate_scale_log = float(np.max(pt["pi_rate"]))
            for nm in ("pi_rate", "pi_heat", "lt_pi_rate", "lt_pi_heat"):
                pt[nm] = pt[nm] - self.rate_scale_log
            t.update(pt)
            # stacked (NTAU, 4) photoion table: one row gather serves all
            # four curves (hot-loop cost; see _tau_lookup)
            t["tau_stack"] = np.stack(
                [t["pi_rate"], t["pi_heat"],
                 t["lt_pi_rate"], t["lt_pi_heat"]], axis=-1)
            lg = t["log_tau"]
            self._ltau0 = float(lg[0])
            self._inv_dltau = float((len(lg) - 1) / (lg[-1] - lg[0]))
            self._n_tau = len(lg)
        else:
            self.rate_scale_log = 0.0
        # -- stacked hot-loop tables -------------------------------------
        # ydot runs up to ~1e3 times per step inside the stiff Newton
        # ladder; individual searchsorted lookups per curve dominate the
        # coupled-step cost.  All grids are log-uniform, so the bin index
        # is arithmetic (no binary search) and every 1D curve comes from
        # ONE pair of row gathers on a (NT, 1+K) stack whose column 0 is
        # the T grid itself (for exact linear-in-T interpolation identical
        # to the reference's table scheme, MPv3.cpp:1655-1676).
        self._t1_names = ("cirh", "C_cih0", "rrhp", "C_rrh", "C_ffhe",
                          "C_cxh0", "C_fbdn", "C_cie", "C_cxch", "C_cxo")
        t["t1_stack"] = np.stack([T] + [t[k] for k in self._t1_names],
                                 axis=-1)
        # 2D (T, ne) tables: one (NT*NE, 3) flat stack, plane interpolation
        # from 3 corner row gathers (reference: MPv3.cpp:1817)
        self._lt0 = float(np.log10(T[0]))
        self._inv_dlt = float((NT - 1) / (np.log10(T[-1]) - np.log10(T[0])))
        self._lne0 = float(np.log10(ne[0]))
        self._inv_dlne = float((NT - 1) /
                               (np.log10(ne[-1]) - np.log10(ne[0])))
        self.tab = {k: jnp.asarray(v) for k, v in t.items()
                    if isinstance(v, np.ndarray)}
        self.tau_bounds = (1.0e-3, 1.0e6)

    # -- thermodynamics ----------------------------------------------------
    def n_H(self, rho):
        return rho / self.mpc.mean_mass_per_h

    def n_tot(self, nH, x):
        return (self.mpc.n_ion + self.mpc.n_elec * x) * nH

    def temperature_of(self, nH, Eint, x):
        return (self.mpc.gamma - 1.0) * Eint / (K_B * self.n_tot(nH, x))

    def temperature(self, P, cfg: SimConfig):
        nH = self.n_H(P[RO])
        x = P[self.mpc.tracer_slot]
        return self.temperature_of(nH, P[PG] / (self.mpc.gamma - 1.0), x)

    def set_temp(self, P, T, cfg: SimConfig):
        """Reset pressure so temperature is T (reference: MPv3.cpp:1053)."""
        nH = self.n_H(P[RO])
        x = P[self.mpc.tracer_slot]
        return P.at[PG].set(self.n_tot(nH, x) * K_B * T)

    # -- fused table lookups (hot loop; see _build_tables) -----------------
    def _t1_lookup(self, Tc):
        """All 1D temperature curves in one fused lookup: two row gathers
        on the stacked table.
        Returns (dict of curve values, iT, Tg[iT], Tg[iT+1])."""
        tb = self.tab
        nt = self.mpc.n_table
        f = (jnp.log10(Tc) - self._lt0) * self._inv_dlt
        i = jnp.clip(f.astype(jnp.int32), 0, nt - 2)
        lo = tb["t1_stack"][i]      # (..., 1+K)
        hi = tb["t1_stack"][i + 1]
        Tgi = lo[..., 0]
        Tgi1 = hi[..., 0]
        w = ((Tc - Tgi) / (Tgi1 - Tgi))[..., None]
        vals = lo[..., 1:] + w * (hi[..., 1:] - lo[..., 1:])
        out = {nm: vals[..., k] for k, nm in enumerate(self._t1_names)}
        return out, i, Tgi, Tgi1

    def _t2_eval(self, Tc, ne):
        """The 2D (T, ne) heating/cooling terms evaluated directly from the
        Wolfire+ (2003) closed forms the reference tabulates
        (reference builds 2D lookup tables from these same expressions and
        plane-interpolates at runtime, MPv3.cpp:1817; direct evaluation is
        the same physics minus the interpolation error, and is pure
        elementwise work instead of 3 corner gathers per table)."""
        Z = self.mpc.metallicity
        lnT = jnp.log(Tc)
        sqT = jnp.sqrt(Tc)
        H_pah = 1.083e-25 * Z / (1.0 + 9.77e-3 * (sqT / ne) ** 0.73)
        C_pah = 3.02e-30 * Z * jnp.exp(
            0.94 * lnT + 0.74 * Tc ** (-0.068) * jnp.log(3.4 * sqT / ne)
        ) * ne
        C_cxce = (1.4e-23 * Z * jnp.exp(-0.5 * lnT - 92.0 / Tc)
                  * ne / (1.0 + 0.05 * ne * (Tc / 2000.0) ** (-0.37)))
        return {"H_pah": H_pah, "C_pah": C_pah, "C_cxce": C_cxce}

    def _tau_lookup(self, tau0, dtau_cur, stack=None):
        """Photoion rate/heat at tau0, tau0+dtau and the low-tau slopes —
        row gathers on the (NTAU, 4) stack.  ``stack`` overrides the
        setup-time table: evolving sources pass the current star's table
        through the rt dict so no recompilation is needed when Teff moves
        (reference: set_multifreq_source_properties re-integrates the
        rate tables on >1% changes, MPv3.cpp:686)."""
        if stack is None:
            stack = self.tab["tau_stack"]
        tmin, tmax = self.tau_bounds

        def rows(tau):
            lt = jnp.log10(jnp.clip(tau, tmin, tmax))
            f = (lt - self._ltau0) * self._inv_dltau
            i = jnp.clip(f.astype(jnp.int32), 0, self._n_tau - 2)
            w = (f - i.astype(f.dtype))[..., None]
            lo = stack[i]
            hi = stack[i + 1]
            v = lo + jnp.clip(w, 0.0, 1.0) * (hi - lo)
            return jnp.exp(TB.LOGTEN * v)

        r0 = rows(tau0)
        r1 = rows(tau0 + dtau_cur)
        return r0, r1

    def set_multifreq_source_properties(self, tstar: float, rstar_cm: float):
        """Re-integrate the multifrequency photoionization tables for new
        stellar properties (reference: MPv3::set_multifreq_source_properties,
        MPv3.cpp:686; called by update_RT_source_properties when an
        evolving source moves >1% in L or T).  Returns the peak-normalized
        (NTAU, 4) stack and its log10 peak — callers feed the stack through
        rt['tau_stack'] and fold 10^(ls_new - ls_setup) into the source's
        relative-strength scale instead of recompiling."""
        pt = TB.build_photoion_tables(tstar, rstar_cm)
        ls = float(np.max(pt["pi_rate"]))
        stack = np.stack([pt["pi_rate"] - ls, pt["pi_heat"] - ls,
                          pt["lt_pi_rate"] - ls, pt["lt_pi_heat"] - ls],
                         axis=-1)
        dtype = np.asarray(self.tab["tau_stack"]).dtype \
            if "tau_stack" in self.tab else np.float64
        return jnp.asarray(stack.astype(dtype)), ls

    # -- the ODE right-hand side (reference: MPv3.cpp:1619-1936) -----------
    def ydot(self, one_minus_x, Eint, nH, rt: Dict):
        c = self.mpc
        omx = jnp.maximum(one_minus_x, MIN_NEUTRAL)
        x = 1.0 - omx
        T = self.temperature_of(nH, Eint, x)
        Tc = jnp.clip(T, c.min_temperature, c.max_temperature)
        expnh = jnp.exp(-nH / 1.0e4)
        ne = c.n_elec * x * nH + nH * 1.5e-4 * c.metallicity * expnh

        tb = self.tab
        t1, iT, Tgi, Tgi1 = self._t1_lookup(Tc)
        t2 = self._t2_eval(Tc, ne)

        def f1(name):
            return t1[name]

        omx_dot = jnp.zeros_like(omx)
        Edot = jnp.zeros_like(Eint)

        # collisional ionization + cooling
        omx_dot -= f1("cirh") * ne * omx
        Edot -= f1("C_cih0") * ne * omx

        # photoionization — summed over ionizing sources (per-source column
        # sets in rt["ion"]; reference: calc_microphysics_dU loops
        # FVI_ionising_srcs, rad_src_data.h per-source Tau slots).  A plain
        # rt dict without "ion" is treated as one source (default_rt, and
        # direct mp.update(..., rt=...) callers).
        if c.ion_src is not None:
            entries = rt.get("ion")
            if entries is None:
                entries = (rt,)
            for e in entries:
                dtau_cur = nH * e["ds"] * omx * SIGMA0
                tau0 = e["tau0"]
                if c.ion_src == "mono":
                    frac = float(TB.hi_xsection_fractional(E_MONO))
                    dtau = dtau_cur * frac
                    # nv = Ndot/Vshell, precomputed on host at f64 so
                    # neither factor is materialized at f32 (both
                    # overflow; the ratio doesn't)
                    nv = e.get("nv", None)
                    if nv is None:
                        nv = e["n_idot"] / e["vshell"]
                    rate = nv * jnp.exp(-tau0 * frac)
                    rate = rate * jnp.where(
                        dtau < 1.0e-4, dtau, 1.0 - jnp.exp(-dtau)) / nH
                    omx_dot -= rate
                    Edot += rate * E_EXCESS
                else:  # mfion (reference: Hi_discrete_multifreq_*:101-155)
                    # tables are peak-normalized (see _build_tables); sv
                    # restores the scale divided by Vshell, f32-safe
                    sv = e.get("sv", None)
                    if sv is None:
                        sv = jnp.exp(TB.LOGTEN * self.rate_scale_log) \
                            / e["vshell"]
                    r0, r1 = self._tau_lookup(tau0, dtau_cur,
                                              stack=e.get("tau_stack"))
                    big = r0[..., 0] - r1[..., 0]
                    small = r0[..., 2] * dtau_cur / (SIGMA0 * nH)
                    pir = jnp.where(dtau_cur < 0.01, small, big) * sv / nH
                    bigh = r0[..., 1] - r1[..., 1]
                    smallh = r0[..., 3] * dtau_cur / (SIGMA0 * nH)
                    pih = jnp.where(dtau_cur < 0.01, smallh, bigh) * sv / nH
                    omx_dot -= pir
                    Edot += pih

        # recombination + cooling
        omx_dot += f1("rrhp") * x * ne
        Edot -= f1("C_rrh") * x * ne
        # He free-free
        Edot -= f1("C_ffhe") * x * ne
        # H0 collisional excitation cooling
        Edot -= f1("C_cxh0") * omx * ne

        # UV/IR heating (Henney+09; reference: MPv3.cpp:1786-1805)
        if c.n_diff_srcs:
            g0uv = rt["g0_uv"]
            g0ir = rt["g0_ir"]
            Edot += 1.9e-26 * c.metallicity * g0uv / (1.0 + 6.4 * (g0uv / nH))
            Edot += 7.7e-32 * c.metallicity * g0ir / (1.0 + 3.0e4 / nH) ** 2

        # cosmic-ray heating and ionization (Wolfire+03)
        Edot += 5.0e-28 * omx
        omx_dot -= 1.8e-17 * omx

        # PAH heating (2D table)
        Edot += omx * t2["H_pah"]

        # metal cooling: max(forbidden-line, CIE + CII-e)
        fbdn = f1("C_fbdn") * x * ne
        cie = f1("C_cie") * x * x * nH
        cie = cie + t2["C_cxce"]
        Edot -= jnp.maximum(fbdn, cie)

        # CII/OI cooling by neutral H collisions (Wolfire+03 eq C1/C3)
        Edot -= f1("C_cxch") * nH * omx * expnh
        Edot -= f1("C_cxo") * nH * omx

        # PAH cooling
        Edot -= t2["C_pah"]

        Edot = Edot * nH
        # limit cooling near the temperature floor (reference: :1888-1890)
        Tmin = c.min_temperature
        cold = (Edot < 0.0) & (T < 2.0 * Tmin)
        Edot = jnp.where(
            cold, jnp.minimum(0.0, Edot * (T - Tmin) / Tmin), Edot)
        return omx_dot, Edot

    # -- integration (reference: MPv3.cpp:1146-1235 + cvode_integrator) ----
    def _stiff_solve(self, omx0, E0, nH, rt, dt, n_sub=32, n_newton=8,
                     stiffness=None):
        """Backward-Euler ladder with vectorized, bound-limited 2x2 Newton
        solves.

        The Newton update is clipped per iteration (|dE| <= 0.6 E,
        |d(1-x)| <= 0.3): the energy equation is non-smooth at the Tmin
        cooling limiter and an unclipped Newton can oscillate across it;
        the clip makes the iteration monotone while staying quadratic near
        the root (the reference leans on CVODE's internal step control for
        the same robustness — cvode_integrator.cpp).

        ``stiffness`` (optional traced scalar: the global max |ydot*dt/y|)
        makes the ladder adaptive: the substep count scales with the
        stiffness (CVODE's step-control equivalent, SIMD-friendly because
        every cell shares the count) and each substep's Newton iteration
        stops on convergence — a mild grid costs ~4x4 RHS evaluations
        instead of the fixed 32x8."""
        if stiffness is not None:
            n_eff = jnp.clip(jnp.ceil(4.0 * stiffness).astype(jnp.int32),
                             2, n_sub)
            h = dt / n_eff
        else:
            n_eff = None
            h = dt / n_sub

        def rhs(omx, E):
            # dtype-preserving: the rate tables are built at the ambient
            # precision (f64 under x64), which would promote an f32 state
            # and break the while-loop carries
            a, b = self.ydot(omx, E, nH, rt)
            return a.astype(omx.dtype), b.astype(E.dtype)

        def newton_step(y, y_prev):
            omx, E = y
            # Jacobian columns via linearize: ONE primal ydot evaluation
            # (with its table gathers) + two linear-only passes, instead of
            # three full evaluations (exact per-cell 2x2, like the JVPs)
            (f0, f1v), lin = jax.linearize(rhs, omx, E)
            one_o = jnp.ones_like(omx)
            zero_o = jnp.zeros_like(omx)
            one_e = jnp.ones_like(E)
            zero_e = jnp.zeros_like(E)
            (j00, j10) = lin(one_o, zero_e)
            (j01, j11) = lin(zero_o, one_e)
            # g(y) = y - y_prev - h*f(y);  J_g = I - h*J_f
            g0 = omx - y_prev[0] - h * f0
            g1 = E - y_prev[1] - h * f1v
            a = 1.0 - h * j00
            b = -h * j01
            cc = -h * j10
            d = 1.0 - h * j11
            det = a * d - b * cc
            det = jnp.where(jnp.abs(det) > 1e-300, det, 1.0)
            d_omx = (d * g0 - b * g1) / det
            d_E = (a * g1 - cc * g0) / det
            d_omx = jnp.clip(d_omx, -0.3, 0.3)
            d_E = jnp.clip(d_E, -0.6 * E, 0.6 * E)
            omx_n = jnp.clip(omx - d_omx, MIN_NEUTRAL, 1.0 - MIN_NEUTRAL)
            E_n = jnp.maximum(E - d_E, 1.0e-10 * y_prev[1])
            return (omx_n, E_n)

        # convergence tolerance tracks the working precision: 1e-11 is
        # below f32 resolution and would force every Newton loop to the
        # n_newton cap in f32
        tol = 1.0e-11 if E0.dtype == jnp.float64 else 1.0e-6

        def newton_converged(y, y_prev):
            """Newton to convergence (or n_newton), global max criterion."""
            def cond(st):
                _y, i, err = st
                return (i < n_newton) & (err > tol)

            def body(st):
                y_c, i, _err = st
                y_n = newton_step(y_c, y_prev)
                err = jnp.maximum(
                    jnp.max(jnp.abs(y_n[0] - y_c[0])),
                    jnp.max(jnp.abs((y_n[1] - y_c[1])
                                    / jnp.maximum(y_c[1], 1e-300))))
                return (y_n, i + 1, err)

            y_out, _, _ = jax.lax.while_loop(
                cond, body, (y, jnp.int32(0), jnp.asarray(jnp.inf,
                                                          dtype=y[1].dtype)))
            return y_out

        if n_eff is None:
            def substep(carry, _):
                omx, E = carry
                y = newton_converged((omx, E), (omx, E))
                return y, None

            (omx1, E1), _ = jax.lax.scan(substep, (omx0, E0), None,
                                         length=n_sub)
            return omx1, E1

        def substep_body(st):
            omx, E, k = st
            omx_n, E_n = newton_converged((omx, E), (omx, E))
            return (omx_n, E_n, k + 1)

        omx1, E1, _ = jax.lax.while_loop(
            lambda st: st[2] < n_eff, substep_body,
            (omx0, E0, jnp.int32(0)))
        return omx1, E1

    def update(self, P, dt, cfg: SimConfig, rt: Optional[Dict] = None):
        """TimeUpdateMP(_RTnew): advance chemistry+energy of every cell by dt
        and return the updated primitive array (jit-cached)."""
        if rt is None:
            rt = self.default_rt(P)
        return self._update_jit(P, dt, cfg, rt)

    def _update_impl(self, P, dt, cfg: SimConfig, rt: Dict):
        c = self.mpc
        # host-float dt traces as weak f64 under x64; the ladder carries
        # must stay in the state dtype
        dt = jnp.asarray(dt, P.dtype)
        nH = self.n_H(P[RO])
        Eint = P[PG] / (c.gamma - 1.0)
        omx = jnp.clip(1.0 - P[c.tracer_slot], MIN_NEUTRAL, 1.0 - MIN_NEUTRAL)
        # floor negative/zero pressure at Tmin (reference: :985-995)
        E_floor = self.n_tot(nH, 1.0 - omx) * K_B * c.min_temperature / (c.gamma - 1.0)
        Eint = jnp.where(Eint > 0.0, Eint, E_floor)

        from ..parallel.mesh import mesh_requested

        sharded = mesh_requested(cfg)
        d_omx, d_E = self.ydot(omx, Eint, nH, rt)
        d_omx = d_omx.astype(omx.dtype)
        d_E = d_E.astype(Eint.dtype)
        maxdelta = jnp.maximum(jnp.abs(d_omx * dt / omx),
                               jnp.abs(d_E * dt / Eint))
        omx_eul = omx + dt * d_omx
        E_eul = Eint + dt * d_E
        use_euler = maxdelta < EULER_CUTOFF
        # global short-circuit: when NO cell is past the Euler cutoff the
        # implicit ladder is skipped entirely at runtime (reference: the
        # per-cell Euler-vs-CVODE branch, MPv3.cpp:1146-1235 EULER_CUTOFF;
        # here the branch must be grid-global to stay SIMD-friendly)
        stiffness = jnp.max(jnp.where(use_euler, 0.0, maxdelta))

        def run_stiff(args):
            omx_a, E_a, nH_a, rt_a = args
            return self._stiff_solve(omx_a, E_a, nH_a, rt_a, dt,
                                     stiffness=stiffness)

        # stiff-cell compaction: the cells past the Euler cutoff are
        # typically a thin shell (the ionization front) — a few % of the
        # grid.  Gather them into a fixed-capacity buffer, run the Newton
        # ladder on the small array, scatter back; fall back to the
        # full-grid ladder if the stiff set overflows the buffer.  (The
        # reference gets the same effect per cell from the CVODE-vs-Euler
        # branch, MPv3.cpp:1146-1235; a dense SIMD ladder must compact
        # explicitly to avoid paying the stiff cost on every cell.)
        ncell = int(np.prod(omx.shape))
        cap = min(ncell, max(4096, ncell // 8))
        if sharded:
            # masked dense ladder: the compaction's global nonzero+take
            # forces an all-gather under GSPMD (PARITY.md audit); the dense
            # ladder is elementwise and therefore shard-local
            cap = ncell
        if cap >= ncell:
            omx_st, E_st = jax.lax.cond(
                jnp.any(~use_euler), run_stiff,
                lambda args: (args[0], args[1]), (omx, Eint, nH, rt))
        else:
            stiff_flat = (~use_euler).ravel()
            grid_shape = omx.shape

            def run_compact(args):
                omx_a, E_a, nH_a, rt_a = args
                (idx,) = jnp.nonzero(stiff_flat, size=cap, fill_value=ncell)
                gidx = jnp.minimum(idx, ncell - 1)  # in-bounds gather; the
                # padded lanes integrate a duplicate of the last cell and
                # are dropped at the scatter below

                def sub(a):
                    return a.ravel()[gidx]

                def sub_tree(v):
                    # rt may nest per-source dicts under "ion"
                    if isinstance(v, dict):
                        return {k2: sub_tree(v2) for k2, v2 in v.items()}
                    if isinstance(v, (tuple, list)):
                        return tuple(sub_tree(v2) for v2 in v)
                    if (hasattr(v, "shape")
                            and tuple(getattr(v, "shape", ())) == grid_shape):
                        return sub(v)
                    return v

                rt_sub = {k: sub_tree(v) for k, v in rt_a.items()}
                o1, e1 = self._stiff_solve(sub(omx_a), sub(E_a), sub(nH_a),
                                           rt_sub, dt, stiffness=stiffness)
                o_out = omx_a.ravel().at[idx].set(o1, mode="drop")
                e_out = E_a.ravel().at[idx].set(e1, mode="drop")
                return (o_out.reshape(grid_shape), e_out.reshape(grid_shape))

            n_stiff = jnp.sum(stiff_flat)
            omx_st, E_st = jax.lax.cond(
                n_stiff > cap, run_stiff,
                lambda args: jax.lax.cond(
                    n_stiff > 0, run_compact,
                    lambda a: (a[0], a[1]), args),
                (omx, Eint, nH, rt))
        omx1 = jnp.where(use_euler, omx_eul, omx_st)
        E1 = jnp.where(use_euler, E_eul, E_st)
        return self._finish_update(P, nH, omx1, E1)

    def _finish_update(self, P, nH, omx1, E1):
        """Shared post-integration clamps + primitive assembly
        (reference: convert_local2prim, MPv3.cpp:1000-1014)."""
        c = self.mpc
        omx1 = jnp.clip(omx1, MIN_NEUTRAL, 1.0 - MIN_NEUTRAL)
        x1 = 1.0 - omx1
        # temperature clamps (reference: convert_local2prim:1000-1014)
        T1 = self.temperature_of(nH, E1, x1)
        ntot = self.n_tot(nH, x1)
        E1 = jnp.where(T1 > 1.01 * c.max_temperature,
                       ntot * K_B * c.max_temperature / (c.gamma - 1.0), E1)
        E1 = jnp.where(T1 < 0.99 * c.min_temperature,
                       ntot * K_B * c.min_temperature / (c.gamma - 1.0), E1)
        out = P.at[PG].set(E1 * (c.gamma - 1.0))
        out = out.at[c.tracer_slot].set(x1)
        return out

    def timescales(self, P, cfg: SimConfig, rt: Optional[Dict] = None):
        """Chemistry timestep limit (reference: MPv3.cpp:1268-1345,
        MP_LIM3-style: DTFRAC / |d(1-x)/dt| plus energy-change limit)."""
        if rt is None:
            rt = self.default_rt(P)
        return self._timescales_jit(P, cfg, rt)

    def cell_timescales(self, P, cfg: SimConfig, rt: Dict):
        c = self.mpc
        nH = self.n_H(P[RO])
        Eint = P[PG] / (c.gamma - 1.0)
        omx = jnp.clip(1.0 - P[c.tracer_slot], MIN_NEUTRAL, 1.0 - MIN_NEUTRAL)
        # same pressure floor as the update
        E_floor = self.n_tot(nH, 1.0 - omx) * K_B * c.min_temperature \
            / (c.gamma - 1.0)
        Eint = jnp.where(Eint > 0.0, Eint, E_floor)
        d_omx, d_E = self.ydot(omx, Eint, nH, rt)
        frac, use_e, use_relx = dtlimit_tier_params(
            getattr(c, "dtlimit_tier", 6))
        num = jnp.maximum(5.0e-2, omx) if use_relx else 1.0
        t = frac * num / (jnp.abs(d_omx) + 1.0e-100)
        if use_e:
            t = jnp.minimum(t, frac * Eint / (jnp.abs(d_E) + 1.0e-100))
        return t

    def _timescales_impl(self, P, cfg: SimConfig, rt: Dict, exclude=None):
        return min_timescale(self.cell_timescales(P, cfg, rt), exclude)

    def default_rt(self, P) -> Dict:
        """No-raytracer defaults (reference: MPv3 constructor :338-346)."""
        z = jnp.zeros_like(P[RO])
        return {
            "tau0": z + 1.0e6, "ds": z, "vshell": z + 1.0e30,
            "n_idot": self.mpc.n_idot, "nv": z, "sv": z,
            "g0_uv": z, "g0_ir": z,
        }
