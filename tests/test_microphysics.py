"""Microphysics tests: rate functions vs literature, analytic recombination,
thermal equilibria (the standalone-rate-check strategy of the reference's
microphysics/testing_scripts, SURVEY.md §4.5)."""
import numpy as np
import jax.numpy as jnp
import pytest

from pion_tpu import Eqn, SimConfig
from pion_tpu.constants import K_B, PG, RO, VX, YEAR
from pion_tpu.microphysics import MPv3, MPv3Config, MPv7, MPOnlyCooling, MPv8
from pion_tpu.microphysics import tables as TB
from pion_tpu.microphysics.cooling import CoolingConfig, MPv8Config
from pion_tpu.microphysics.mpv7 import MPv7Config


def cfg_with_tracer():
    return SimConfig(ndim=1, eqn=Eqn.EULER, ntracer=1, shape=(8,),
                     xmin=(0.0,), xmax=(1.0,), bcs=(("outflow", "outflow"),))


def uniform_state(cfg, nH=100.0, T=1.0e4, x=1.0):
    mpc = MPv3Config(tracer_slot=5)
    rho = nH * mpc.mean_mass_per_h
    ntot = (mpc.n_ion + mpc.n_elec * x) * nH
    P = np.zeros((cfg.nvar, 8))
    P[RO] = rho
    P[PG] = ntot * K_B * T
    P[5] = x
    return jnp.asarray(P), mpc


# -- rate sanity vs published values ---------------------------------------

def test_recomb_rate_vs_literature():
    # Hummer94 case-B at 1e4 K: alpha_B ~ 2.59e-13 cm^3/s
    a = float(TB.hii_rad_recomb_rate(1.0e4))
    assert abs(a - 2.59e-13) / 2.59e-13 < 0.02


def test_coll_ion_rate_vs_literature():
    # Voronov-type fit at 1e5 K within a factor ~2 of 2.5e-8... use exact form
    cir, cicr = TB.hi_coll_ion_rates(np.array([1.0e5]))
    assert 1e-9 < cir[0] < 1e-7
    assert cicr[0] == pytest.approx(2.18e-11 * cir[0])


def test_cie_cooling_peak():
    # WSS09 metals-only curve peaks around 2e5 K at ~1e-21.3 erg cm^3/s
    T = np.logspace(4.2, 7.0, 200)
    L = TB.cooling_rate_wss09_metals(T)
    Tpk = T[np.argmax(L)]
    assert 1.0e5 < Tpk < 4.0e5
    assert 3e-22 < L.max() < 8e-22


def test_photoion_tables_monotone():
    tabs = TB.build_photoion_tables(Tstar=4.0e4, Rstar_cm=10.0 * 6.96e10,
                                    n_sub=200, n_spl=20)
    # rates decrease monotonically with optical depth
    assert np.all(np.diff(tabs["pi_rate"]) <= 1e-10)
    assert np.all(np.diff(tabs["pi_heat"]) <= 1e-10)


# -- MPv3 integration ------------------------------------------------------

def test_mpv3_recombination_analytic():
    """No sources, cooling disabled by fixing T via high floor: pure
    recombination obeys 1/(1-x') - 1/(1-x0) ~ alpha*ne*t."""
    cfg = cfg_with_tracer()
    P, mpc = uniform_state(cfg, nH=1000.0, T=1.0e4, x=0.99)
    mp = MPv3(MPv3Config(tracer_slot=5, min_temperature=5000.0))
    dt = 100.0 * YEAR
    out = mp.update(P, dt, cfg)
    x1 = float(out[5][0])
    assert x1 < 0.99
    # analytic: x(t) = x0/(1 + x0*alpha*1.1*nH*t) gives ~0.52 at alpha(1e4K);
    # T cools toward the 5000K floor so alpha grows and x ends slightly lower
    assert 0.40 < x1 < 0.60


def test_mpv3_cooling_drives_to_floor():
    cfg = cfg_with_tracer()
    P, mpc = uniform_state(cfg, nH=1.0e4, T=3.0e4, x=0.5)
    mp = MPv3(MPv3Config(tracer_slot=5, min_temperature=100.0))
    out = P
    dt = 300.0 * YEAR
    for _ in range(20):
        out = mp.update(out, dt, cfg)
    T_end = float(mp.temperature(out, cfg)[0])
    assert T_end < 3.0e4
    assert np.all(np.isfinite(np.asarray(out)))


def test_mpv3_photoionization_heats_and_ionizes():
    cfg = cfg_with_tracer()
    P, mpc = uniform_state(cfg, nH=100.0, T=100.0, x=1e-6)
    mp = MPv3(MPv3Config(tracer_slot=5, ion_src="mono", n_idot=1.0e48,
                         min_temperature=50.0))
    nH = 100.0
    ds = 3.0e16
    r = 1.0e17
    rt = {
        "tau0": jnp.zeros(8) + 0.0,
        "ds": jnp.zeros(8) + ds,
        "vshell": jnp.zeros(8) + 4.0 * np.pi * r * r * ds,
        "n_idot": 1.0e48,
        "g0_uv": jnp.zeros(8),
        "g0_ir": jnp.zeros(8),
    }
    out = mp.update(P, 30.0 * YEAR, cfg, rt=rt)
    x1 = float(out[5][0])
    T1 = float(mp.temperature(out, cfg)[0])
    assert x1 > 0.5, f"should ionize strongly, got x={x1}"
    assert T1 > 1000.0, f"should heat, got T={T1}"
    assert np.all(np.isfinite(np.asarray(out)))


def test_mpv3_timescales_positive():
    cfg = cfg_with_tracer()
    P, mpc = uniform_state(cfg)
    mp = MPv3(MPv3Config(tracer_slot=5))
    t = float(mp.timescales(P, cfg))
    assert t > 0.0 and np.isfinite(t)


# -- MPv7 / MPv8 / cooling-only -------------------------------------------

def test_mpv7_equilibrium_stromgren_balance():
    cfg = cfg_with_tracer()
    mp = MPv7(MPv7Config(tracer_slot=5, ion_src=None))
    P, _ = uniform_state(cfg, nH=100.0, x=0.9)
    out = mp.update(P, 1.0e4 * YEAR, cfg)
    # no source: recombination wins
    assert float(out[5][0]) < 0.9
    # temperature slaved to x
    T = float(mp.temperature(out, cfg)[0])
    assert 100.0 <= T <= 1.0e4


def test_mp_only_cooling():
    cfg = SimConfig(ndim=1, eqn=Eqn.EULER, shape=(8,), xmin=(0.0,),
                    xmax=(1.0,), bcs=(("outflow", "outflow"),))
    mp = MPOnlyCooling(CoolingConfig(min_temperature=1.0e4))
    P = np.zeros((cfg.nvar, 8))
    n = 1.0
    T0 = 1.0e6
    P[RO] = n * 0.61 * 1.67262192369e-24
    P[PG] = n * K_B * T0
    out = mp.update(jnp.asarray(P), 3.0e13, cfg)
    T1 = float(mp.temperature(out, cfg)[0])
    assert T1 < T0
    assert T1 >= 1.0e4 * 0.99


def test_mpv8_heating_cooling_balance():
    cfg = cfg_with_tracer()
    mp = MPv8(MPv8Config(tracer_slot=5, ion_src=None, min_temperature=50.0,
                         max_temperature=1.0e4))
    P, _ = uniform_state(cfg, nH=100.0, T=5000.0, x=0.0)
    out = P
    for _ in range(30):
        out = mp.update(out, 1.0e3 * YEAR, cfg)
    T = float(mp.temperature(out, cfg)[0])
    # should approach the low equilibrium temperature
    assert 40.0 < T < 5000.0
    assert np.isfinite(T)


def test_cooling_curve_menu():
    """All six mp_only_cooling Edot functions (reference:
    mp_only_cooling.cpp:383-411): signs and equilibria behave physically and
    every curve integrates stably."""
    from pion_tpu.microphysics.cooling import (COOLING_CURVES, CoolingConfig,
                                               MPOnlyCooling)
    from pion_tpu.constants import M_P as MP_

    rho = 1.0 * MP_ * 1.4   # n_mu = 1
    for cv in COOLING_CURVES:
        mp = MPOnlyCooling(CoolingConfig(curve=cv, min_temperature=5.0))
        # hot gas always cools
        ed_hot = float(mp.edot(jnp.asarray(rho), jnp.asarray(1.0e7)))
        assert ed_hot < 0.0, cv
        # curves with heating terms must heat very cold dilute gas
        if cv in ("KI02", "WSS09_CIE_ONLY_COOLING"):
            ed_cold = float(mp.edot(jnp.asarray(rho * 1e-4),
                                    jnp.asarray(10.0)))
            assert ed_cold > 0.0, cv
        # stable integration from 1e6 K
        cfg = SimConfig(ndim=1, shape=(8,), xmin=(0.0,), xmax=(1.0,),
                        bcs=(("outflow", "outflow"),))
        P = np.zeros((cfg.nvar, 8))
        P[RO] = rho
        n = rho / (mp.mpc.mu * MP_)
        P[PG] = n * 1.380649e-16 * 1.0e6
        out = np.asarray(mp._update_impl(jnp.asarray(P), 3.156e13, cfg, {}))
        assert np.all(np.isfinite(out)), cv
        T_out = float(mp.temperature(jnp.asarray(out), cfg)[0])
        assert T_out < 1.0e6, f"{cv}: hot gas did not cool ({T_out})"


def test_ki02_equilibrium_two_phase():
    """KI02 has the classic two-phase equilibrium: heating/cooling balance
    gives T_eq decreasing with density."""
    from pion_tpu.microphysics.cooling import CoolingConfig, MPOnlyCooling
    from pion_tpu.constants import M_P as MP_
    mp = MPOnlyCooling(CoolingConfig(curve="KI02", min_temperature=5.0))

    def teq(n):
        rho = n * 1.4 * MP_
        Ts = np.logspace(0.8, 4.5, 400)
        ed = np.array([float(mp.edot(jnp.asarray(rho), jnp.asarray(t)))
                       for t in Ts])
        i = np.argmax(ed < 0)    # first T where cooling wins
        return Ts[i]

    assert teq(100.0) < teq(1.0) < teq(0.01)


def test_mp_timestep_limit_modes_and_tiers():
    """EP.MP_timestep_limit mode menu (reference: sim_params.h:56-63,
    calc_timestep.cpp:444-458) + MPV3_DTLIMIT tiers (MPv3.cpp:185-228):
    mode/tier selection must change the chemistry dt as upstream does."""
    import jax.numpy as jnp

    from pion_tpu import SimConfig
    from pion_tpu.constants import PG, RO
    from pion_tpu.microphysics import MPv3, MPv3Config
    from pion_tpu.microphysics.cooling import CoolingConfig, MPOnlyCooling
    from pion_tpu.physics import Physics

    cfg = SimConfig(ndim=1, eqn="euler", solver="hll", ntracer=1,
                    shape=(16,), xmin=(0.0,), xmax=(1.0e18,),
                    bcs=(("outflow", "outflow"),), dtype="float64")
    P = np.zeros((cfg.nvar, 16))
    P[RO] = 2.0e-22
    P[PG] = 2.0e-10          # hot enough that cooling is active
    P[cfg.eqn.nbase] = 0.5
    P = jnp.asarray(P)

    # MPv3: every nonzero mode applies its timescale (flags ignored
    # upstream, MPv3.cpp:1237-1252); tiers change DTFRAC
    t2 = MPv3(MPv3Config(tracer_slot=cfg.eqn.nbase, dtlimit_tier=2))
    t3 = MPv3(MPv3Config(tracer_slot=cfg.eqn.nbase, dtlimit_tier=3))
    dt2 = float(t2.timescales(P, cfg))
    dt3 = float(t3.timescales(P, cfg))
    assert dt3 == pytest.approx(0.5 * dt2, rel=1e-10)
    # tier 6 adds the energy-change limit -> never larger than tier 2
    t6 = MPv3(MPv3Config(tracer_slot=cfg.eqn.nbase, dtlimit_tier=6))
    assert float(t6.timescales(P, cfg)) <= dt2 * (1 + 1e-12)

    # cooling-only module: modes 1-3 limit by the cooling time, mode 4
    # (recomb only) has no applicable process -> no limit
    # (reference: mp_only_cooling.cpp:333-341 'if (!tc) return 1.0e99')
    mp = MPOnlyCooling(CoolingConfig(curve="WSS09_CIE_ONLY_COOLING"))
    for mode, limited in ((1, True), (2, True), (3, True), (4, False),
                          (0, False)):
        phys = Physics(mp=mp, dt_limit=mode)
        if mode == 0:
            continue  # mode 0 short-circuits before timescale()
        ts = float(phys.timescale(P, cfg))
        if limited:
            assert ts < 1.0e90
        else:
            assert ts > 1.0e90


def test_stiff_compaction_overflow_matches_dense():
    """When the stiff set exceeds the compaction capacity (cap = ncell/8),
    the update must take the full dense ladder and agree with the
    compacted path's semantics (VERDICT r4 item 10: pin the overflow
    branch before building on it)."""
    import jax.numpy as jnp

    from pion_tpu import SimConfig
    from pion_tpu.constants import PG, RO
    from pion_tpu.microphysics import MPv3, MPv3Config
    from pion_tpu.microphysics.mpv3 import EULER_CUTOFF, MIN_NEUTRAL

    cfg = SimConfig(ndim=3, eqn="euler", solver="hll", ntracer=1,
                    shape=(40, 40, 40), xmin=(0.0,) * 3, xmax=(1.0,) * 3,
                    bcs=tuple([("outflow", "outflow")] * 3),
                    dtype="float64")
    mpc = MPv3Config(tracer_slot=cfg.eqn.nbase, min_temperature=50.0)
    mp = MPv3(mpc)
    rng = np.random.default_rng(11)
    n = cfg.shape
    P = np.zeros((cfg.nvar,) + n)
    P[RO] = 2.34e-22 * (1.0 + rng.random(n))
    # hot ionized gas cooling hard -> a large stiff fraction at big dt
    P[PG] = 2.0e-10 * (1.0 + rng.random(n))
    P[cfg.eqn.nbase] = 0.99
    P = jnp.asarray(P)
    rt = mp.default_rt(P)
    dt = jnp.float64(1.0e12)

    # confirm the stiff set really overflows cap
    nH = mp.n_H(P[RO])
    Eint = P[PG] / (mpc.gamma - 1.0)
    omx = jnp.clip(1.0 - P[cfg.eqn.nbase], MIN_NEUTRAL, 1.0 - MIN_NEUTRAL)
    d_omx, d_E = mp.ydot(omx, Eint, nH, rt)
    maxdelta = jnp.maximum(jnp.abs(d_omx * dt / omx),
                           jnp.abs(d_E * dt / Eint))
    n_stiff = int(jnp.sum(maxdelta >= EULER_CUTOFF))
    ncell = 40 ** 3
    cap = max(4096, ncell // 8)
    assert n_stiff > cap, f"test setup: {n_stiff} stiff <= cap {cap}"

    out_overflow = mp._update_impl(P, dt, cfg, rt)

    # dense-ladder reference: same Euler/stiff select with cap >= ncell
    import pion_tpu.microphysics.mpv3 as M

    use_euler = maxdelta < EULER_CUTOFF
    stiffness = jnp.max(jnp.where(use_euler, 0.0, maxdelta))
    E_floor = mp.n_tot(nH, 1.0 - omx) * 1.380649e-16 * \
        mpc.min_temperature / (mpc.gamma - 1.0)
    Eint_f = jnp.where(Eint > 0.0, Eint, E_floor)
    o_st, e_st = mp._stiff_solve(omx, Eint_f, nH, rt, dt,
                                 stiffness=stiffness)
    o_ref = jnp.where(use_euler, omx + dt * d_omx, o_st)
    e_ref = jnp.where(use_euler, Eint_f + dt * d_E, e_st)
    ref = mp._finish_update(P, nH, o_ref, e_ref)
    np.testing.assert_allclose(np.asarray(out_overflow),
                               np.asarray(ref), rtol=1e-12, atol=0)


# -- table lookups against NumPy interpolation of the same tables ----------

def _log_uniform(lo, hi, n, dtype, seed):
    rng = np.random.default_rng(seed)
    return (10.0 ** rng.uniform(np.log10(lo), np.log10(hi), n)).astype(dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mpv3_t1_lookup_matches_numpy_interp(dtype):
    """The stacked row-gather lookup of every 1D temperature curve equals
    linear-in-T interpolation of the named tables (all 200 rows)."""
    mp = MPv3(MPv3Config(tracer_slot=5))
    Tg = np.asarray(mp.tab["T"])
    T = _log_uniform(Tg[0], Tg[-1], 4096, dtype, 1)
    T[:3] = np.asarray(Tg[[0, 57, -1]], dtype=dtype)   # on grid points
    vals, _i, _lo, _hi = mp._t1_lookup(jnp.asarray(T))
    Tref = T.astype(np.float64)
    rtol = 1e-10 if dtype == "float64" else 1e-5
    for name in mp._t1_names:
        ref = np.interp(Tref, Tg, np.asarray(mp.tab[name]))
        np.testing.assert_allclose(np.asarray(vals[name]), ref, rtol=rtol,
                                   atol=1e-12 * np.abs(ref).max(),
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mpv3_tau_lookup_matches_numpy_interp(dtype):
    """The photoionization rate/heat lookup equals 10^(linear-in-log-tau
    interpolation) of the named mfion tables, with tau clipped to the
    table's bounds."""
    from pion_tpu.constants import RSUN

    mp = MPv3(MPv3Config(tracer_slot=5, ion_src="mfion", n_idot=1e48,
                         tstar=3.75e4, rstar_cm=10.0 * RSUN))
    lg = np.asarray(mp.tab["log_tau"])
    tau0 = _log_uniform(1e-4, 1e7, 4096, dtype, 2)
    dtau = _log_uniform(1e-3, 1e2, 4096, dtype, 3)
    r0, r1 = mp._tau_lookup(jnp.asarray(tau0), jnp.asarray(dtau))
    tmin, tmax = mp.tau_bounds
    rtol = 1e-10 if dtype == "float64" else 2e-4
    # f32 compares where f32 can represent the rate (deep-tail values
    # below its normal range are zero in an f32 run)
    floor = 0.0 if dtype == "float64" else np.finfo(np.float32).tiny
    for tau, r in ((tau0, r0), (tau0 + dtau, r1)):
        lt = np.log10(np.clip(tau.astype(np.float64), tmin, tmax))
        for k, name in enumerate(("pi_rate", "pi_heat", "lt_pi_rate",
                                  "lt_pi_heat")):
            ref = 10.0 ** np.interp(lt, lg, np.asarray(mp.tab[name]))
            keep = ref > floor
            assert keep.mean() > 0.5
            np.testing.assert_allclose(np.asarray(r[..., k])[keep],
                                       ref[keep], rtol=rtol, err_msg=name)


_NP_EDOT = {
    "KI02": lambda f, ne, ni, nmu: 2.0e-26 * nmu - nmu * nmu * f["ki02"],
    "SD93_CIE": lambda f, ne, ni, nmu: -ne * ni * f["sd93"],
    "SD93_PLUS_HEATING":
        lambda f, ne, ni, nmu: ne * nmu * f["heat"] - ne * ni * f["sd93"],
    "WSS09_CIE_ONLY_COOLING":
        lambda f, ne, ni, nmu: 2.0e-26 * nmu - nmu * nmu * f["sd93"],
    "WSS09_CIE_PLUS_HEATING":
        lambda f, ne, ni, nmu: ne * nmu * f["heat"] - nmu * nmu * f["sd93"],
    "WSS09_CIE_LINE_HEAT_COOL": lambda f, ne, ni, nmu: (
        np.minimum(-f["C_fbdn"] * ne * nmu, -f["sd93"] * nmu * nmu)
        - f["C_rrh"] * ne * nmu - f["C_ffhe"] * ne * nmu
        + 8.01e-12 * f["rrhp"] * ne * nmu),
}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("curve", sorted(_NP_EDOT))
def test_cooling_edot_matches_numpy_interp(curve, dtype):
    """mp_only_cooling's row-gather Edot equals the same curve assembled
    from NumPy interpolation of its 300-row per-component tables."""
    mp = MPOnlyCooling(CoolingConfig(curve=curve, min_temperature=10.0,
                                     max_temperature=1.0e9))
    Tg = np.asarray(mp.Tg)
    T = _log_uniform(1.0, 1.0e10, 4096, dtype, 4)    # includes clipping
    rho = _log_uniform(1e-26, 1e-20, 4096, dtype, 5)
    got = np.asarray(mp.edot(jnp.asarray(rho), jnp.asarray(T)))
    Tc = np.clip(T.astype(np.float64), Tg[0], Tg[-1])
    f = {k: np.interp(Tc, Tg, np.asarray(v)) for k, v in mp.tab.items()}
    r = rho.astype(np.float64)
    ref = _NP_EDOT[curve](f, r / mp.MU_ELEC, r / mp.MU_ION, r / mp.MU)
    rtol = 1e-10 if dtype == "float64" else 1e-4
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=1e-9 * np.abs(ref).max())
