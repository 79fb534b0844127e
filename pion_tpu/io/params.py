"""icgen-style key-value parameter files.

Equivalent of the reference's text-parameter pipeline
(reference: source/dataIO/readparams.cpp + the typed parameter registry in
dataIO/parameter_defs.h:56; file format as in
test_problems/advection/params_*.txt: one `name value` pair per line,
'#' comments).  ``read_paramfile`` parses the file; ``config_from_params``
maps the reference's parameter names (as used by the actual
test_problems/*.txt files — ndim, coordinates, eqn, solver, GAMMA, CFL,
NGridX/Y/Z, Xmin/Ymin/Zmin, BC_XN.., FinishTime, ...) onto a
:class:`SimConfig`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..config import SimConfig
from ..constants import BC, Coord, Eqn, Solver

# string values from real param files (reference: ics/get_sim_info.cpp:89-119)
_EQN_STR = {"hd": Eqn.EULER, "euler": Eqn.EULER,
            "i-mhd": Eqn.MHD, "mhd-i": Eqn.MHD, "idealmhd": Eqn.MHD,
            "mhd": Eqn.GLM, "glm-mhd": Eqn.GLM, "glm": Eqn.GLM}
_EQN_INT = {1: Eqn.EULER, 2: Eqn.MHD, 9: Eqn.GLM}
_COORD_STR = {"cartesian": Coord.CARTESIAN, "cylindrical": Coord.CYLINDRICAL,
              "axisymmetric": Coord.CYLINDRICAL, "spherical": Coord.SPHERICAL}
_COORD_INT = {1: Coord.CARTESIAN, 2: Coord.CYLINDRICAL, 3: Coord.SPHERICAL}
# FLUX_RS ids (reference: source/constants.h:238-246)
_SOLVER = {0: Solver.LF, 1: Solver.LINEAR, 2: Solver.EXACT, 3: Solver.HYBRID,
           4: Solver.RCV, 5: Solver.RPV, 6: Solver.FVS, 7: Solver.HLLD,
           8: Solver.HLL}
_BC = {"periodic": BC.PERIODIC, "outflow": BC.OUTFLOW,
       "absorbing": BC.OUTFLOW, "zero-gradient": BC.OUTFLOW,
       "oneway_out": BC.ONEWAY_OUT, "owo": BC.ONEWAY_OUT,
       "one-way-outflow": BC.ONEWAY_OUT,
       "inflow": BC.INFLOW, "fixed": BC.FIXED, "reflecting": BC.REFLECTING,
       "refl": BC.REFLECTING, "axisymmetric": BC.AXISYMMETRIC,
       "axi": BC.AXISYMMETRIC, "jet": BC.JET, "jetreflect": BC.JETREFLECT,
       "dmach": BC.DMACH, "dmach2": BC.DMACH2,
       "equator-reflect": BC.REFLECTING}


def read_paramfile(path: str) -> Dict[str, str]:
    """Parse `name value` lines; later entries override earlier ones
    (reference: readparams.cpp)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split(None, 1)
            if len(parts) == 2:
                out[parts[0]] = parts[1].strip()
    return out


def apply_overrides(params: Dict[str, str], overrides) -> Dict[str, str]:
    """CLI-style name=value overrides (reference: sim_init.cpp:329-660).

    Override names are matched case-insensitively against existing keys
    (the reference accepts lowercase ``finishtime=`` for the header's
    ``FinishTime``); otherwise the override is stored as given."""
    out = dict(params)
    lower = {k.lower(): k for k in out}
    for ov in overrides:
        if "=" in ov:
            k, v = ov.split("=", 1)
            k = k.strip()
            key = lower.get(k.lower(), k)
            out[key] = v.strip()
            lower[key.lower()] = key
    return out


def _enum_param(raw, str_map, int_map, default):
    if raw is None or raw == "":
        return default
    s = str(raw).strip().lower()
    if s in str_map:
        return str_map[s]
    return int_map[int(s)]


def config_from_params(params: Dict[str, str], **extra) -> SimConfig:
    """Build a SimConfig from reference parameter names.

    Accepts the names used by the reference's real test_problems files
    (NGridX, Xmin/Xmax, GAMMA, CFL, BC_XN, string eqn/coordinates) plus the
    older aliases (NgridX, XminX, CFLno, gamma, int codes)."""
    g = lambda k, d=None: params.get(k, d)

    def gf(keys, default):
        for k in keys if isinstance(keys, (list, tuple)) else [keys]:
            v = params.get(k)
            if v is not None and v != "":
                return v
        return default

    ndim = int(gf(["ndim", "gridndim"], 1))
    # reference axis order is (x,y,z); our array order is reversed
    ns = [int(gf([f"NGrid{a}", f"Ngrid{a}"], 0) or 0) for a in "XYZ"][:ndim]
    xmins = [float(gf([f"{a}min", f"Xmin{a}"], 0.0) or 0.0)
             for a in "XYZ"][:ndim]
    xmaxs = [float(gf([f"{a}max", f"Xmax{a}"], 1.0) or 1.0)
             for a in "XYZ"][:ndim]
    shape = tuple(reversed(ns))
    xmin = tuple(reversed(xmins))
    xmax = tuple(reversed(xmaxs))

    def bc_pair(a):
        lo = _BC[str(gf([f"BC_{a}N", f"BC{a}n"], "outflow")).lower()]
        hi = _BC[str(gf([f"BC_{a}P", f"BC{a}p"], "outflow")).lower()]
        return (lo, hi)

    bcs = tuple(reversed([bc_pair(a) for a in "XYZ"[:ndim]]))
    eqn = _enum_param(gf(["eqn", "eqntype"], None), _EQN_STR, _EQN_INT,
                      Eqn.EULER)
    coords = _enum_param(gf(["coordinates", "coordsys"], None), _COORD_STR,
                         _COORD_INT, Coord.CARTESIAN)
    av_flag = int(gf("ArtificialViscosity", 0) or 0)
    av = {0: "none", 1: "falle", 3: "hcorr", 4: "hcorr_falle"}.get(av_flag,
                                                                   "none")

    # nested-grid section (reference: sim_params.h:232-238; level extents
    # from NG_centre per setup_NG_grid.cpp:88-160).  NG_refine != 1 would
    # change per-level cell counts — unused by every reference test config.
    nlevels = int(gf(["grid_nlevels"], 1) or 1)
    ng_centre = None
    if nlevels > 1:
        cents = [float(gf([f"NG_centre_{a}{a}"], 0.0) or 0.0)
                 for a in "XYZ"][:ndim]
        ng_centre = tuple(reversed(cents))
        for a in "XYZ"[:ndim]:
            r = gf([f"NG_refine_{a}{a}"], 1)
            assert int(r or 1) == 1, \
                "NG_refine != 1 (anisotropic refinement) is not supported"
    cfg = SimConfig(
        ndim=ndim,
        eqn=eqn,
        coords=coords,
        solver=_SOLVER[int(gf(["solver", "solverType"], 8))],
        ntracer=int(str(gf("ntracer", "0")).split()[0]),
        gamma=float(gf(["GAMMA", "gamma"], 5.0 / 3.0)),
        cfl=float(gf(["CFL", "CFLno", "cfl"], 0.3)),
        ooa=int(gf(["OrderOfAccSpace", "ooa"], 2)),
        av=av,
        etav=float(gf("EtaViscosity", 0.1)),
        shape=shape,
        xmin=xmin,
        xmax=xmax,
        bcs=bcs,
        min_temperature=float(gf(["EP_Min_Temperature",
                                  "EP_MinTemperature"], 0.0)),
        max_temperature=float(gf(["EP_Max_Temperature",
                                  "EP_MaxTemperature"], 1.0e100)),
        tmax=float(gf(["FinishTime", "finishtime"], 1.0)),
        nlevels=nlevels,
        ng_centre=ng_centre,
        # precision: the reference's pion_flt compile flag becomes a
        # run-time param (functionality_flags.h); float64 matches upstream
        # defaults, float32 is the reduced-precision mode
        dtype=str(gf(["dtype", "pion_flt"], "float64")).strip(),
        # extension key (not in the reference dialect): halo mode
        halo=str(gf(["halo"], "gspmd")).strip(),
        **extra,
    )
    return cfg
