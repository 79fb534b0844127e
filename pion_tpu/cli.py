"""User-facing entry points — the reference's ``icgen`` and ``pion`` binaries.

Reference: source/ics/icgen.cpp:83-257 (param file -> grid -> IC generator
dispatch -> snapshot) and source/main.cpp:62-158 (param file OR restart
snapshot -> Init -> Time_Int -> Finalise, with restart auto-detection at
main.cpp:99-112 and CLI ``name=value`` overrides at sim_init.cpp:329-660).

Usage::

    python -m pion_tpu icgen params_problem.txt [name=value ...]
    python -m pion_tpu run   params_problem.txt [name=value ...]
    python -m pion_tpu run   snapshot.snap      [name=value ...]

Reads the reference's actual parameter-file dialect (test_problems/*.txt),
including radiation-source (``RT_*``), stellar-wind (``WIND_*``) and
chemistry (``chem_code``/``EP_*``) sections.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np

from .config import SimConfig
from .constants import MSUN, RSUN, YEAR, PG, RO, VX
from .io.params import apply_overrides, config_from_params, read_paramfile

KM = 1.0e5


def _array_order(xyz, ndim):
    """Reference (x,y,z) -> array-order tuple of length ndim."""
    return tuple(reversed(xyz[:ndim]))


# ---------------------------------------------------------------------------
# IC dispatch (reference: ics/icgen_base.cpp:36-130 setup_ics_type)
# ---------------------------------------------------------------------------

def _ambient_from_params(cfg, params, prefix="PEC_amb"):
    """Ambient primitive state from e.g. PEC_ambRO/PG/VX.../TR0... params."""
    g = lambda k, d=0.0: float(params.get(prefix + k, d))
    state = np.zeros(cfg.nvar)
    state[RO] = g("RO", 1.0)
    state[PG] = g("PG", 1.0)
    for i, c in enumerate("XYZ"):
        state[VX + i] = g("V" + c)
    if cfg.eqn.is_mhd:
        from .constants import BX

        for i, c in enumerate("XYZ"):
            state[BX + i] = g("B" + c)
    for i in range(cfg.ntracer):
        state[cfg.eqn.nbase + i] = g(f"TR{i}")
    return state


def cfg_ics_overrides(cfg: SimConfig, params: Dict[str, str]) -> SimConfig:
    """Config overrides forced by the IC generator itself — predefined
    shock-tube tests pin gamma and the finish time (reference:
    get_riemann_ics sets SimPM->gamma/finishtime, shock_tube.cpp:483-485)."""
    if params.get("ics") == "ShockTube":
        n = int(params.get("STnumber", 1))
        if n > 0:
            from .ics.shocktube import test_meta

            gam, tf = test_meta(n)
            kw = {}
            if gam is not None:
                kw["gamma"] = gam
            if tf is not None:
                kw["tmax"] = tf
            if kw:
                cfg = cfg.with_(**kw)
    return cfg


def build_ics(cfg: SimConfig, params: Dict[str, str]) -> np.ndarray:
    """Generate the initial primitive state for the ``ics`` named problem."""
    from . import ics as gen

    name = params.get("ics", "Uniform")
    gp = lambda k, d: type(d)(params.get(k, d))

    if name == "ShockTube":
        from .ics.shocktube import predefined_test
        from .ics.shocktube import shocktube as generic_shocktube

        n = int(params.get("STnumber", 1))
        ang = float(int(params.get("STangleXY", 0))) * np.pi / 180.0
        if ang < 0.0:
            ang = np.arctan(0.5)  # reference: shock_tube.cpp:130
        if n > 0:
            return predefined_test(cfg, n, angle_xy=ang)
        # user-specified states: STpostvec* = left, STprevec* = right
        # (reference: get_riemann_ics(number, postshock, preshock, ..))
        def vec(prefix):
            out = np.zeros(cfg.nvar)
            for nm, slot in (("RO", RO), ("PG", PG), ("VX", VX),
                             ("VY", VX + 1), ("VZ", VX + 2)):
                out[slot] = float(params.get(prefix + nm, 0.0))
            if cfg.eqn.is_mhd:
                from .constants import BX

                for k, c in enumerate("XYZ"):
                    out[BX + k] = float(params.get(prefix + "B" + c, 0.0))
            for i in range(cfg.ntracer):
                out[cfg.eqn.nbase + i] = float(
                    params.get(f"{prefix}TR{i}", 0.0))
            return out

        x0 = float(params.get("STshockpos", 0.0))
        return generic_shocktube(cfg, vec("STpostvec"), vec("STprevec"), x0,
                                 angle_xy=ang)
    if name == "Uniform":
        from .ics.problems import uniform

        # reference: ics/basic_tests.cpp:150-310 setup_uniformgrid —
        # UNIFORM_amb* ambient (B in Gauss -> /sqrt(4pi), NEW_B_NORM),
        # optional isothermal-sphere core rho0/(1+(rc/r)^slope) + radial
        # velocity about UNIFORM_core_centre
        state = _ambient_from_params(cfg, params, prefix="UNIFORM_amb")
        if cfg.eqn.is_mhd:
            from .constants import BX as iBX

            state[iBX:iBX + 3] /= np.sqrt(4.0 * np.pi)
        P = uniform(cfg, state)
        slope = float(params.get("UNIFORM_radial_slope", 0.0) or 0.0)
        rc = float(params.get("UNIFORM_core_radius", 0.0) or 0.0)
        rv = float(params.get("UNIFORM_radial_velocity", 0.0) or 0.0)
        # reference applies the core whenever the params are present and the
        # slope is nonzero — rc==0 still applies the radial velocity (the
        # density factor then reduces to 1), and all 3 velocity slots are
        # set (out-of-plane components are 0 since dpos-centre vanishes)
        if slope != 0.0 and "UNIFORM_core_radius" in params:
            cnames = ["XX", "YY", "ZZ"]
            centre = [float(params.get(f"UNIFORM_core_centre_{cnames[i]}",
                                       0.0) or 0.0)
                      for i in range(cfg.ndim)]
            axes = [np.asarray(cfg.cell_centers(a)) - centre[cfg.ndim - 1 - a]
                    for a in range(cfg.ndim)]
            mesh = np.meshgrid(*axes, indexing="ij")
            d = np.sqrt(sum(m * m for m in mesh))
            d = np.maximum(d, 1e-300)
            if rc != 0.0:
                fac = 1.0 / (1.0 + (rc / d) ** slope)
                P[RO] *= fac
                P[PG] *= fac
            for k in range(3):
                P[VX + k] = 0.0
            for a in range(cfg.ndim):
                P[VX + (cfg.ndim - 1 - a)] = rv * mesh[a] / d
        return P
    if name == "Advection":
        return gen.advection_pulse(cfg)
    if name == "AdvectSineWave":
        return gen.advect_sine_wave(cfg)
    if name == "OrszagTang":
        return gen.orszag_tang(cfg)
    if name in ("KelvinHelmholz", "KelvinHelmholzStone"):
        return gen.kelvin_helmholtz(cfg)
    if name == "FieldLoop":
        return gen.field_loop(cfg)
    if name == "FieldLoopVz":
        return gen.field_loop(cfg, vz=1.0)
    if name == "FieldLoopStatic":
        return gen.field_loop(cfg, v=(0.0, 0.0))
    if name == "LiskaWendroffImplosion":
        return gen.liska_wendroff_implosion(cfg)
    if name == "DoubleMachRef":
        return gen.double_mach_reflection(cfg)
    if name in ("Jet", "JET", "jet"):
        return gen.jet_ambient(
            cfg, rho_amb=gp("JETambRO", 1.0), p_amb=gp("JETambPG", 1.0))
    if name in ("RadiativeShock", "RadiativeShockOutflow"):
        fn = (gen.radiative_shock if name == "RadiativeShock"
              else gen.radiative_shock_outflow)
        return fn(cfg, vsh=gp("RADSH_vs", 1.0e7), rho0=gp("RADSH_r0", 1.0e-22),
                  T0=gp("RADSH_T0", 1.0e4))
    if name in ("LaserAblationAxi", "LaserAblation3D"):
        return gen.laser_ablation(cfg)
    if name == "ShockCloud":
        return gen.shock_cloud(cfg, mach=gp("SCmach", 10.0),
                               rho_cloud=gp("SCdratio", 10.0))
    if name in ("BlastWave", "BlastWave_File"):
        return gen.blast_wave(cfg)
    if name in ("Clump_Spherical", "Clump_Axisymmetric"):
        return gen.spherical_clump(cfg)
    if name in ("PhotEvap_RandomClumps", "PERC", "PERC2",
                "PhotEvap_RandomClumps2"):
        return gen.random_clumps(cfg, seed=int(params.get("PERCrandomseed", 0)))
    if name in ("PhotEvap_MultiClumps_FixNum", "PE_MC_FN"):
        return gen.multi_clumps(cfg, mode="fixnum")
    if name in ("PhotEvap_MultiClumps_FixMass", "PE_MC_FM"):
        return gen.multi_clumps(cfg, mode="fixmass")
    if name in ("PhotoEvaporatingClump", "PhotoEvaporatingClump2", "PEC",
                "PEC2"):
        amb = _ambient_from_params(cfg, params)
        # radius/centre semantics: radius is a fraction of the y-range
        # (x-range in 1D); centre from PEC_{x,y,z}pos in physical coords
        # (reference: photoevaporating_clump.cpp:114-121, :276-296)
        yax = 0 if cfg.ndim == 1 else cfg.ndim - 2
        radius = gp("PECcloudradius", 0.1) * (cfg.xmax[yax] - cfg.xmin[yax])
        center = _array_order(
            [float(params.get(f"PEC_{c}pos", 0.0)) for c in "xyz"], cfg.ndim)
        cltr = [float(params.get(f"PECcloudTR{v}", 0.0))
                for v in range(cfg.ntracer)]
        return gen.photoevaporating_clump(
            cfg, amb, dratio=gp("PECdratio", 1.0),
            pratio=gp("PECpratio", 1.0), bratio=gp("PECBratio", 1.0),
            cloud_tracers=cltr, radius=radius, center=center)
    if name == "PhotoEvap_radial":
        center = _array_order(
            [float(params.get(f"PEC_xpos{d}",
                              0.5 * (cfg.xmin[cfg.ndim - 1 - d]
                                     + cfg.xmax[cfg.ndim - 1 - d])
                              if d < cfg.ndim else 0.0))
             for d in range(3)], cfg.ndim)
        r0 = float(params.get("PECcloudradius",
                              0.1 * (cfg.xmax[0] - cfg.xmin[0])))
        return gen.photoevap_radial(cfg, _ambient_from_params(cfg, params),
                                    cloud_center=center, r0=r0)
    if name == "PhotoEvap_powerlaw":
        return gen.photoevap_powerlaw(cfg, _ambient_from_params(cfg, params))
    if name == "PhotoEvap_paralleltest":
        return gen.photoevap_paralleltest(cfg,
                                          _ambient_from_params(cfg, params))
    if name == "PhotoEvap_CloudClump":
        return gen.photoevap_cloudclump(cfg)
    if name.startswith("StarBench_"):
        from .ics import starbench as sb

        if name.startswith("StarBench_ContactDiscontinuity"):
            return sb.contact_discontinuity(
                cfg, test_id=int(name[-1]),
                vx=float(params.get("StarBench_ContDisc_VX", 0.0)),
                vy=float(params.get("StarBench_ContDisc_VY", 0.0)))
        if name.startswith("StarBench_IFI"):
            test = name[-1] if name[-1] in "ABC" else "A"
            return sb.ifi_test(cfg, test=test)
        if name == "StarBench_IrrCloud_Uniform":
            return sb.irradiated_cloud(cfg, profile="uniform")
        if name == "StarBench_IrrCloud_IsoSph":
            return sb.irradiated_cloud(cfg, profile="isosph")
        if name == "StarBench_TremblinCooling":
            return sb.tremblin_cooling(cfg)
        if name == "StarBench_Cone":
            return sb.cone(cfg)
        raise ValueError(f"unknown StarBench problem {name}")
    if name == "1Dto2D":
        from .io import load_snapshot
        from .ics import map_1d_to_2d

        cfg1, P1, _t, _s = load_snapshot(params["ICfilename"])
        r = cfg1.cell_centers(0)
        return map_1d_to_2d(r, np.asarray(P1), cfg)
    if name == "ReadBBTurbulence":
        from .ics import from_turbulence_cube

        cube = np.load(params["BBT_file"])
        rho = cube["rho"] if hasattr(cube, "files") else cube
        return from_turbulence_cube(cfg, rho)
    raise ValueError(f"unknown ics type {name!r} "
                     "(reference menu: icgen_base.cpp:36-130)")


# ---------------------------------------------------------------------------
# Physics from the RT_* / WIND_* / chem_code sections
# ---------------------------------------------------------------------------

def _tracer_slot(cfg: SimConfig, params) -> int:
    """Index of the H ion-fraction tracer (Tracer000 H1+ style names)."""
    for i in range(cfg.ntracer):
        nm = params.get(f"Tracer{i:03d}", "").lower()
        if nm in ("h1+", "hii", "h1p", "ion-h", "x_h1+"):
            return cfg.eqn.nbase + i
    return cfg.eqn.nbase  # first tracer by convention


def sources_from_params(cfg: SimConfig, params) -> List:
    """RT_* section -> raytracing Source list
    (reference: dataio_base.cpp RT_ parameter registry; effect codes 1=UV
    heating, 2=mono-photoionisation, 3=multifrequency)."""
    from .raytracing import Source

    n = int(params.get("RT_Nsources", 0) or 0)
    out = []
    for i in range(n):
        g = lambda k, d=0.0: float(params.get(f"RT_{k}_{i}",
                                              params.get(f"RT_{k}__{i}",
                                              params.get(f"RT_{k}____{i}", d))))
        pos_xyz = [float(params.get(f"RT_position_{i}_{d}", 0.0))
                   for d in range(3)]
        effect = {1: "uv_heating", 2: "mono", 3: "mfion"}[
            int(g("effect__", g("effect", 2)))]
        at_inf = bool(int(g("at_infty", 0)))
        # time-evolving source properties (reference: RT_EVO_FILE_i,
        # dataio_base.cpp:1281; setup_evolving_RT_sources)
        evo = None
        evofile = str(params.get(f"RT_EVO_FILE_{i}", "NOFILE"))
        if evofile not in ("", "NONE", "NOFILE"):
            from .raytracing import StarEvolution

            evo = StarEvolution.from_file(evofile)
        src = Source(
            position=_array_order(pos_xyz, cfg.ndim),
            at_infinity=at_inf,
            strength=g("strength", 0.0),
            effect=effect,
            evolution=evo,
        )
        out.append(src)
    return out


def winds_from_params(cfg: SimConfig, params) -> List:
    """WIND_* section -> WindSource list (reference: stellar_wind_BC.cpp
    add_source — Mdot in Msun/yr, velocities in km/s, :167-172; type codes
    stellar_wind_BC.h:41-44)."""
    from .winds import WindSource, load_evolution_file

    n = int(params.get("WIND_NSRC", 0) or 0)
    out = []
    for i in range(n):
        g = lambda k, d=0.0: float(params.get(f"WIND_{i}_{k}", d))
        s = lambda k, d="": params.get(f"WIND_{i}_{k}", d)
        pos_xyz = [g(f"pos{d}") for d in range(3)]
        wtype = int(g("type", 0))
        model = {0: "iso", 1: "iso", 2: "angle", 3: "latdep"}[wtype]
        evo = None
        evofile = s("evofile", "NONE")
        if evofile not in ("", "NONE", "NOFILE"):
            evo = load_evolution_file(evofile)
        tracers = tuple(g(f"TR{k}") for k in range(cfg.ntracer))
        out.append(WindSource(
            position=_array_order(pos_xyz, cfg.ndim),
            radius=g("radius"),
            mdot=g("mdot") * MSUN / YEAR,
            vinf=g("vinf") * KM,
            t_wind=g("temp", 1.0e4),
            rstar=g("Rstr", 7.0e10),
            v_rot=g("vrot", g("Vrot", 0.0)) * KM,
            b_star=g("Bsrf", 0.0),
            tracers=tracers,
            evolution=evo,
            model=model,
            xi=g("xi", -0.43),
            orb_period=g("orbital_period", 0.0),
            eccentricity_fac=g("ecentricity_fac", g("eccentricity_fac", 1.0))
            or 1.0,
            periastron=(g("periastron_vec_x"), g("periastron_vec_y")),
        ))
    return out


def physics_from_params(cfg: SimConfig, params) -> Optional[object]:
    """chem_code + RT_* + WIND_* -> a Physics bundle, or None for pure
    dynamics (reference dispatch: setup_fixed_grid.cpp:270-410)."""
    from .physics import Physics
    from .utils import ensure_precision

    # the chemistry tables become device arrays here: switch x64 on first
    # for float64 runs, or they are built in float32
    ensure_precision(cfg)

    sources = sources_from_params(cfg, params)
    winds = winds_from_params(cfg, params)
    chem = params.get("chem_code", "None")
    gf0 = lambda k, d: float(params.get(k, d) or d)
    cooling_code = int(gf0("EP_cooling", 0))
    chemistry_on = bool(int(gf0("EP_chemistry", 0)))
    if chem in ("None", "none", "NONE", ""):
        # EP_cooling without EP_chemistry selects mp_only_cooling even
        # with chem_code none (reference: setup_fixed_grid.cpp:267-273
        # "Requested cooling but no chemistry")
        if cooling_code and not chemistry_on:
            chem = "mp_only_cooling"
        elif not winds:
            return None
        else:
            return Physics(wind_sources=winds)

    slot = _tracer_slot(cfg, params)
    ion = [s for s in sources if s.effect in ("mono", "mfion")]
    n_diff = sum(1 for s in sources if s.effect == "uv_heating")
    gf = lambda k, d: float(params.get(k, d))
    common = dict(
        tracer_slot=slot,
        gamma=cfg.gamma,
        helium_mass_frac=gf("EP_Helium_MassFrac", 0.2703),
        metal_mass_frac=gf("EP_Metal_MassFrac", 0.0142),
        min_temperature=gf("EP_Min_Temperature", 10.0) or 10.0,
        max_temperature=gf("EP_Max_Temperature", 1.0e9),
        ion_src=(ion[0].effect if ion else None),
        n_idot=(ion[0].strength if ion else 0.0),
        n_diff_srcs=n_diff,
        # MPV3_DTLIMIT tier (reference compile flag,
        # functionality_flags.h:63; runtime-selectable here)
        dtlimit_tier=int(gf("MPV3_DTLIMIT", 6)),
    )
    if chem == "MPv3":
        from .microphysics import MPv3, MPv3Config

        mp = MPv3(MPv3Config(
            **common,
            tstar=gf("RT_Tstar____0", 0.0),
            rstar_cm=gf("RT_Rstar____0", 0.0) * RSUN,
        ))
    elif chem == "MPv5":
        from .microphysics import MPv5, MPv3Config

        mp = MPv5(MPv3Config(
            **common,
            tstar=gf("RT_Tstar____0", 0.0),
            rstar_cm=gf("RT_Rstar____0", 0.0) * RSUN,
        ))
    elif chem == "MPv6":
        from .microphysics import MPv6, MPv3Config

        mp = MPv6(MPv3Config(
            **common,
            tstar=gf("RT_Tstar____0", 0.0),
            rstar_cm=gf("RT_Rstar____0", 0.0) * RSUN,
        ))
    elif chem == "MPv7":
        from .microphysics.mpv7 import MPv7, MPv7Config

        mp = MPv7(MPv7Config(
            tracer_slot=slot,
            ion_src=(ion[0].effect if ion else None),
            n_idot=(ion[0].strength if ion else 0.0),
            t_lo=gf("EP_Min_Temperature", 100.0) or 100.0,
            t_hi=gf("MPv7_Thi", 1.0e4),
        ))
    elif chem == "MPv8":
        from .microphysics.cooling import MPv8, MPv8Config

        mp = MPv8(MPv8Config(tracer_slot=slot))
    elif chem in ("mp_only_cooling", "MPonly", "only_cooling"):
        from .microphysics.cooling import CoolingConfig, MPOnlyCooling

        # EP_cooling int codes (reference: mp_only_cooling.cpp:42-48)
        curve = {2: "KI02", 3: "KI02", 4: "SD93_CIE",
                 5: "SD93_PLUS_HEATING", 6: "WSS09_CIE_PLUS_HEATING",
                 7: "WSS09_CIE_ONLY_COOLING",
                 8: "WSS09_CIE_LINE_HEAT_COOL"}.get(
            int(gf("EP_cooling", 4)), "SD93_CIE")
        mp = MPOnlyCooling(CoolingConfig(
            gamma=cfg.gamma,
            min_temperature=gf("EP_Min_Temperature", 10.0) or 10.0,
            max_temperature=gf("EP_Max_Temperature", 1.0e9),
            curve=curve,
        ))
    else:
        raise ValueError(f"unknown chem_code {chem!r}")
    # EP_MP_timestep_limit: the full reference mode menu (sim_params.h:
    # 56-63): 0 off, 1 cooling, 2 cooling+recomb, 3 +ionisation, 4 recomb
    # only (calc_timestep.cpp:444-458 switch)
    dt_lim = int(gf("EP_MP_timestep_limit", 1))
    return Physics(mp=mp, sources=sources, wind_sources=winds,
                   dt_limit=dt_lim)


def jet_from_params(cfg: SimConfig, params) -> Optional[tuple]:
    """N_JET section -> (radius_cm, jet inflow state) for BoundaryData.jet
    (reference: ics/jet.cpp:78-125 — JETradius in CELLS, JETdensity,
    JETpressure, JETvelocity, JET_Bax/JET_Btor with the B/sqrt(4pi)
    internal unit)."""
    if int(params.get("N_JET", 0) or 0) < 1:
        return None
    from .ics.problems import jet_state

    gp = lambda k, d: float(params.get(k, d))
    state = jet_state(cfg, rho_jet=gp("JETdensity", 1.0),
                      p_jet=gp("JETpressure", 1.0),
                      v_jet=gp("JETvelocity", 1.0))
    if cfg.eqn.is_mhd:
        from .constants import BX

        s4pi = np.sqrt(4.0 * np.pi)
        state[BX] = gp("JET_Bax", 0.0) / s4pi
        state[BX + 2] = gp("JET_Btor", 0.0) / s4pi  # toroidal = z in 2D
    radius_cells = gp("JETradius", 1.0)
    return (radius_cells * cfg.dx, state)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _outfile(params) -> str:
    import os

    path = params.get("OutputPath", "./")
    name = params.get("OutputFile", "pion_tpu_run")
    return os.path.join(path, name)


def equilibrate_mp(P: np.ndarray, cfg: SimConfig, params) -> np.ndarray:
    """Chemistry equilibration pass before writing ICs (reference:
    ICsetup_base::equilibrate_MP, icgen_base.cpp:147-210, called from
    icgen.cpp:216 when EP_chemistry is on and InitIons != NO): integrate
    the no-RT chemistry for 2x50 substeps of 50 cell-dynamical-times with
    the energy held fixed (the reference disables EP.update_erg), so
    RT+chemistry runs start from ionization equilibrium instead of
    hand-set ion fractions."""
    chem = params.get("chem_code", "None")
    if chem in ("None", "none", "NONE", ""):
        return P
    if not int(float(params.get("EP_chemistry", 0) or 0)):
        return P
    init = str(params.get("InitIons", "YES")).upper()
    if init in ("NO", "N"):
        return P
    phys = physics_from_params(cfg, params)
    if phys is None or phys.mp is None:
        return P
    import jax.numpy as jnp

    from .constants import PG as _PG, RO as _RO

    # 50 cell-dynamical-times from the first cell's sound speed
    # (icgen_base.cpp:184-188 uses FirstPt)
    flat0 = tuple(0 for _ in cfg.shape)
    cs = float(np.sqrt(cfg.gamma * P[(_PG,) + flat0] / P[(_RO,) + flat0]))
    tint = 50.0 * cfg.dx / cs
    Pj = jnp.asarray(P.astype(cfg.np_dtype))
    E0 = Pj[_PG]
    mp = phys.mp
    for _ in range(100):
        Pj = mp.update(Pj, tint, cfg)
        Pj = Pj.at[_PG].set(E0)   # update_erg=false equivalent
    out = np.asarray(Pj)
    if not np.all(np.isfinite(out)):
        raise RuntimeError("equilibrate_MP produced non-finite state")
    return out.astype(cfg.np_dtype)


def icgen_main(argv: List[str]) -> str:
    """``icgen`` equivalent: param file -> IC snapshot.  For
    ``grid_nlevels > 1`` the generator is evaluated on every level's
    extents and a multi-level snapshot is written (reference:
    ics/icgen.cpp:83-257 serial, ics/icgen_NG.cpp per-level loop)."""
    from .ics import add_noise
    from .io import save_snapshot

    params = apply_overrides(read_paramfile(argv[0]), argv[1:])
    cfg = cfg_ics_overrides(config_from_params(params), params)
    noise = float(params.get("noise", -1) or -1)

    def one_level(c):
        P = build_ics(c, params)
        if P.shape != (c.nvar,) + c.shape:
            raise ValueError(
                f"IC generator {params.get('ics')!r} produced shape "
                f"{P.shape}, expected {(c.nvar,) + c.shape}")
        if noise > 0.0:
            P = add_noise(P, c, noise)
        return P.astype(c.np_dtype)

    if cfg.nlevels > 1:
        from .ng import make_level_cfg, snap_ng_centre

        centre = snap_ng_centre(cfg)
        lcfgs = [make_level_cfg(cfg, l, centre) for l in range(cfg.nlevels)]
        P = np.stack([equilibrate_mp(one_level(c), c, params)
                      for c in lcfgs])
    else:
        P = equilibrate_mp(one_level(cfg), cfg, params)
    path = save_snapshot(_outfile(params) + ".00000000", P, cfg,
                         float(params.get("StartTime", 0.0)), 0,
                         extra={"params": params})
    print(f"icgen: wrote {path} ({cfg.nlevels} level(s))")
    return path


def _output_opts(params: Dict[str, str]) -> Dict[str, object]:
    """Output cadence options shared by UG and NG runs
    (reference: sim_init.cpp:671-760 output_data; OutputCriterion 0 =
    step-count cadence, 1 = simulation-time cadence)."""
    crit = int(params.get("OutputCriterion", 0) or 0)
    return dict(
        opfreq=(int(params.get("OutputFrequency", 0) or 0)
                if crit == 0 else 0),
        opfreq_time=(float(params.get("OPfreqTime", 0.0) or 0.0)
                     if crit == 1 else 0.0),
        checkpoint_freq=int(params.get("checkpt_freq", 0) or 0),
        log_freq=int(params.get("log_freq", 16) or 0),
    )


def run_main(argv: List[str]) -> "object":
    """``pion`` equivalent: param file or restart snapshot -> run.
    Routes to the NG driver when grid_nlevels > 1 (the pion-ng binary,
    reference: main_NG.cpp) and rebuilds chemistry/RT/winds from the
    snapshot header on restart (reference: main.cpp:62-158 with restart
    detect at :99-112; sim_init.cpp:173-321)."""
    import os

    import jax.numpy as jnp

    from .ng import NGHierarchy
    from .sim import Simulation

    from .parallel.mesh import maybe_distributed_init

    maybe_distributed_init()
    target = argv[0]
    overrides = argv[1:]
    is_snapshot = any(target.endswith(s) for s in (".snap", ".npz")) or (
        os.path.exists(target) and open(target, "rb").read(6) in
        (b"PTSNAP", b"PK\x03\x04\x00\x00"))
    if is_snapshot:
        from .io.snapshot import load_snapshot_raw

        cfg, _P, _t, _s, extra = load_snapshot_raw(target)
        params = apply_overrides(dict((extra or {}).get("params") or {}),
                                 overrides)
        if cfg.nlevels > 1:
            sim = NGHierarchy.restart(target)
        else:
            sim = Simulation.restart(target)
        if params.get("mesh"):
            # restart constructs before overrides apply: re-shard (or
            # de-shard) the loaded state to honor the requested mesh mode
            from .parallel.mesh import make_mesh, mesh_requested, shard_state

            if cfg.nlevels > 1:
                sim.cfg0 = sim.cfg0.with_(mesh=params["mesh"])
                for c in range(len(sim.cfgs)):
                    sim.cfgs[c] = sim.cfgs[c].with_(mesh=params["mesh"])
                if mesh_requested(sim.cfg0) and not hasattr(sim, "mesh"):
                    sim.mesh = make_mesh(sim.cfg0)
                    sim.P = [shard_state(p, sim.mesh, sim.cfg0)
                             for p in sim.P]
                    sim._jit_cache = {}
            else:
                sim.cfg = sim.cfg.with_(mesh=params["mesh"])
                if mesh_requested(sim.cfg) and not hasattr(sim, "mesh"):
                    sim.mesh = make_mesh(sim.cfg)
                    sim.P = shard_state(sim.P, sim.mesh, sim.cfg)
        tmax = params.get("FinishTime") or params.get("finishtime")
        if tmax:
            if cfg.nlevels > 1:
                sim.cfgs[0] = sim.cfgs[0].with_(tmax=float(tmax))
            else:
                sim.cfg = sim.cfg.with_(tmax=float(tmax))
        sim.outfile = (os.path.join(params["OutputPath"],
                                    params["OutputFile"])
                       if "OutputFile" in params and "OutputPath" in params
                       else target.rsplit(".", 1)[0])
        for k, v in _output_opts(params).items():
            setattr(sim, k, v)
        sim.params = params or None
    else:
        params = apply_overrides(read_paramfile(target), overrides)
        cfg = cfg_ics_overrides(config_from_params(params), params)
        if params.get("mesh"):
            cfg = cfg.with_(mesh=params["mesh"])
        phys = physics_from_params(cfg, params)
        t0 = float(params.get("StartTime", 0.0))
        opts = _output_opts(params)
        if cfg.nlevels > 1:
            from .ng import make_level_cfg, snap_ng_centre

            centre = snap_ng_centre(cfg)
            states = [jnp.asarray(
                build_ics(make_level_cfg(cfg, l, centre), params)
                .astype(cfg.np_dtype)) for l in range(cfg.nlevels)]
            sim = NGHierarchy(cfg, physics=phys)
            sim.t = t0
            sim.set_states(states)
            sim.outfile = _outfile(params)
            for k, v in opts.items():
                setattr(sim, k, v)
            sim.params = params
        else:
            P = build_ics(cfg, params)
            jet = jet_from_params(cfg, params)
            sim = Simulation(cfg, jnp.asarray(P.astype(cfg.np_dtype)),
                             t=t0, physics=phys, outfile=_outfile(params),
                             jet=jet, params=params, **opts)
    max_steps = int(params.get("max_steps", 10**9) or 10**9)
    chunk = int(params.get("chunk", 1) or 1)
    if chunk > 1:
        sim.run(max_steps=max_steps, chunk=chunk)
    else:
        sim.run(max_steps=max_steps)
    print(f"run: finished at t={sim.t:.6e} after {sim.step_count} steps")
    return sim


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2 or argv[0] not in ("icgen", "run"):
        print(__doc__)
        return 2
    if argv[0] == "icgen":
        icgen_main(argv[1:])
    else:
        run_main(argv[1:])
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
