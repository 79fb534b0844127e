"""Short-characteristics raytracing as wavefront scans.

JAX re-derivation of the reference raytracer
(reference: source/raytracing/raytracer_SC.cpp).  The reference walks cells
outward from the source in strict per-octant order — a pointer-chasing,
inherently serial sweep (raytracer_SC.cpp:1543-1562) that parallelizes
across MPI ranks only as a causal pipeline (raytracer_SC_pllel.cpp:156-221).

Here the sweep is re-derived as a scan over L1 shells (|di|+|dj|+|dk| =
const): with the C2Ray upstream interpolation (Mellema et al. 2006 eq. A5;
reference: interpolate_2D/interpolate_3D at raytracer_SC.cpp:2627-2682),
every cell depends only on cells in strictly smaller L1 shells, so each
shell is one dense masked gather/compute/scatter step inside a
``jax.lax.scan`` — parallel across the whole shell, sequential only in the
2N (2D) / 3N (3D) shell index.

Sources at infinity (axis-parallel rays) reduce to a plain cumulative sum
(reference: raytracer_USC_infinity::trace_column_parallel,
raytracer_SC.cpp:716-753).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SimConfig
from ..grid import Geometry


@dataclasses.dataclass(frozen=True)
class StarEvolution:
    """Time-interpolated radiation-source properties from a stellar-
    evolution table (reference: setup_fixed_grid.cpp:595-688
    setup_evolving_RT_sources reads 'time M L Teff Mdot vrot vcrit vinf'
    and stores log10 L/T/R; update_evolving_RT_sources:695-790 linearly
    interpolates the logs in time and re-applies when L or T move >1%)."""

    time: np.ndarray      # s
    log_L: np.ndarray     # log10 L [erg/s]
    log_T: np.ndarray     # log10 Teff [K]
    log_R: np.ndarray     # log10 R* [cm]

    @classmethod
    def from_file(cls, path: str) -> "StarEvolution":
        SIGMA_SB = 5.670367e-5  # reference: constants.h StefanBoltzmannConst
        rows = []
        with open(path) as f:
            for line in f.readlines()[2:]:
                parts = line.split()
                if len(parts) >= 4:
                    rows.append([float(x) for x in parts[:4]])
        if not rows:
            raise ValueError(f"no data rows in evolution file {path}")
        a = np.asarray(rows)
        time, lum, teff = a[:, 0], a[:, 2], a[:, 3]
        rstar = np.sqrt(lum / (4.0 * np.pi * SIGMA_SB * teff**4))
        return cls(time=time, log_L=np.log10(lum), log_T=np.log10(teff),
                   log_R=np.log10(rstar))

    def at(self, t: float):
        """(L [erg/s], Teff [K], Rstar [cm]) at time t — log-linear
        interpolation, clamped to the table ends (the reference holds the
        last line constant past the end)."""
        lL = float(np.interp(t, self.time, self.log_L))
        lT = float(np.interp(t, self.time, self.log_T))
        lR = float(np.interp(t, self.time, self.log_R))
        return 10.0 ** lL, 10.0 ** lT, 10.0 ** lR


@dataclasses.dataclass(frozen=True)
class Source:
    """Radiation source (reference: raytracing/rad_src_data.h:27-76)."""

    position: Tuple[float, ...] = ()   # physical position, array order
    at_infinity: bool = False
    axis: int = -1                     # for at_infinity: array axis of rays
    sign: int = 1                      # +1: rays travel toward +axis
    strength: float = 0.0              # Ndot [1/s] or flux [1/cm^2/s]
    effect: str = "mono"               # mono | mfion | uv_heating
    tau_min: float = 0.7               # C2Ray interpolation floor
    # stellar-evolution table driving (strength, Teff, Rstar) in time
    # (reference: rad_src_info.EvoFile, rad_src_data.h:66)
    evolution: Optional[StarEvolution] = None
    # per-source stellar properties for mfion (reference:
    # rad_src_info.Tstar/Rstar, rad_src_data.h:44-46) — 0 means "use the
    # chemistry module's setup-time table"
    tstar: float = 0.0
    rstar_cm: float = 0.0


def parallel_rays(dtau: jnp.ndarray, axis: int, sign: int, dx: float):
    """Column densities for a source at infinity: tau at cell entry is the
    exclusive cumulative sum of per-cell dtau along the ray direction."""
    ax = axis
    if sign > 0:
        cum = jnp.cumsum(dtau, axis=ax)
        tau_entry = cum - dtau
    else:
        rev = jnp.flip(dtau, axis=ax)
        cum = jnp.flip(jnp.cumsum(rev, axis=ax), axis=ax)
        tau_entry = cum - dtau
    ds = jnp.full_like(dtau, dx)
    vshell = ds  # reference: set_Vshell_in_cell for at_infinity (:2697-2703)
    return tau_entry, ds, vshell


class PointSourceTracer:
    """Point-source short-characteristics tracer for one source position.

    All geometry (shell ordering, upstream neighbor indices, interpolation
    weights, path lengths, shell volumes) is precomputed in numpy at setup;
    the traced part is a single lax.scan over shells operating on flat
    column arrays.
    """

    def __init__(self, cfg: SimConfig, geom: Geometry, pos: Tuple[float, ...],
                 tau_min: float = 0.7):
        self.cfg = cfg
        self.tau_min = tau_min * (6.0 / 7.0 if cfg.ndim == 3 else 1.0)
        nd = cfg.ndim
        shape = cfg.shape
        dx = geom.dx
        ng = cfg.ng

        # cell-center coordinates and integer offsets from the source cell
        centers = [g.pos[ng:-ng] for g in geom.axes]
        src_idx = [int(np.clip(np.argmin(np.abs(centers[a] - pos[a])),
                               0, shape[a] - 1)) for a in range(nd)]
        self.src_idx = tuple(src_idx)
        self.src_pos = np.array([centers[a][src_idx[a]] for a in range(nd)])

        grids = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
        d = [g - s for g, s in zip(grids, src_idx)]         # integer offsets
        ad = [np.abs(x) for x in d]
        sgn = [np.sign(x).astype(int) for x in d]

        # L1 shell index of every cell
        p = sum(ad)
        # major axis = largest |offset| (ties -> lower axis index, matching
        # the reference's diffx>=diffy ordering with x the LAST array axis,
        # so compare from the fast axis backwards)
        order = list(range(nd - 1, -1, -1))  # prefer x, then y, then z
        maj = np.full(shape, order[0])
        best = ad[order[0]].copy()
        for a in order[1:]:
            take = ad[a] > best
            maj = np.where(take, a, maj)
            best = np.where(take, ad[a], best)

        # path length through cell: ds = dx*sqrt(1+sum(delta_i^2))
        with np.errstate(divide="ignore", invalid="ignore"):
            deltas = [np.where(best > 0, adk / np.maximum(best, 1), 0.0)
                      for adk in ad]
        sum_d2 = sum(dk * dk for k, dk in enumerate(deltas)) - 1.0  # rm major
        sum_d2 = np.maximum(sum_d2, 0.0)
        ds = dx * np.sqrt(1.0 + sum_d2)
        ds = np.where(p == 0, 0.5 * dx, ds)
        self.ds = ds

        # shell volume (reference: set_Vshell_in_cell:2690-2721)
        r_cell = np.sqrt(sum((dd * dx) ** 2 for dd in d))
        rs = np.maximum(r_cell - 0.5 * ds, 0.0)
        self.vshell = 4.0 * np.pi * ((rs + ds) ** 3 - rs**3) / 3.0

        # upstream neighbor flat indices (c1: entry-face nbr on major axis;
        # c2/c3: c1 shifted toward source on perp axes; c4: double-diagonal)
        flat = np.arange(int(np.prod(shape))).reshape(shape)

        def shift_idx(offsets):
            idx = [np.clip(grids[a] - offsets[a], 0, shape[a] - 1)
                   for a in range(nd)]
            return flat[tuple(idx)]

        # per-cell offsets toward the source along each axis
        off_major = [np.where(maj == a, sgn[a], 0) for a in range(nd)]
        self.c1 = shift_idx(off_major)
        if nd >= 2:
            # perp axes in cyclic order after the major axis
            perp1 = (maj + 1) % nd if nd == 2 else None
            if nd == 2:
                off_p1 = [off_major[a] + np.where(maj != a, sgn[a], 0)
                          for a in range(nd)]
                self.c2 = shift_idx(off_p1)
            else:
                # 3D: two perpendicular axes
                perp_off = []
                for a in range(nd):
                    perp_off.append(np.where(maj != a, sgn[a], 0))
                # c2: major + first perp; c3: major + second perp;
                # c4: major + both perps.  "first"/"second" per cell: the
                # two non-major axes in increasing axis order.
                firsts = []
                seconds = []
                for a in range(nd):
                    others = [b for b in range(nd) if b != a]
                    firsts.append(others[0])
                    seconds.append(others[1])
                first_ax = np.choose(maj, firsts)
                second_ax = np.choose(maj, seconds)
                off_c2 = [off_major[a] + np.where(first_ax == a, sgn[a], 0)
                          for a in range(nd)]
                off_c3 = [off_major[a] + np.where(second_ax == a, sgn[a], 0)
                          for a in range(nd)]
                off_c4 = [off_major[a] + np.where(maj != a, sgn[a], 0)
                          for a in range(nd)]
                self.c2 = shift_idx(off_c2)
                self.c3 = shift_idx(off_c3)
                self.c4 = shift_idx(off_c4)
                d1 = np.choose(first_ax, deltas)
                d2 = np.choose(second_ax, deltas)
                self.delta0 = d1
                self.delta1 = d2
        if nd == 2:
            mino = np.minimum(ad[0], ad[1])
            self.delta0 = np.where(best > 0, mino / np.maximum(best, 1), 0.0)

        # on-axis correction (reference: cell_cols_2d:2181-2218): cells with
        # mindiff==0 take the entry neighbor's column scaled by a geometric
        # factor when close to the source (maxdiff<10 cells)
        if nd == 1:
            min_off = np.zeros(shape, dtype=int)
        elif nd == 2:
            min_off = np.minimum(ad[0], ad[1])
        else:
            # 3D "on axis" = both non-major offsets zero, i.e. the
            # second-largest offset vanishes
            min_off = np.sort(np.stack(ad), axis=0)[1]
        on_axis = (min_off == 0) & (p > 0)
        m = best.astype(float)
        with np.errstate(divide="ignore", invalid="ignore"):
            corr = np.sqrt((m * m + 0.25) / ((m - 1) ** 2 + 0.25)) * \
                np.where(m > 0, (m - 1) / np.maximum(m, 1), 0.0)
        corr = np.where((m < 10) & (m >= 1), corr, 1.0)
        if nd == 1:
            corr = np.ones_like(corr)  # 1D rays: plain accumulation
        self.on_axis = on_axis
        self.axis_corr = np.where(on_axis, corr, 1.0)

        # shells: group flat cell indices by p
        pf = p.ravel()
        order_cells = np.argsort(pf, kind="stable")
        self.n_shells = int(pf.max()) + 1
        counts = np.bincount(pf, minlength=self.n_shells)
        width = int(counts.max())
        shell_idx = np.full((self.n_shells, width), -1, dtype=np.int32)
        start = 0
        for s in range(self.n_shells):
            c = counts[s]
            shell_idx[s, :c] = order_cells[start : start + c]
            start += c
        self.shell_idx = jnp.asarray(shell_idx)
        self.shell_mask = jnp.asarray(shell_idx >= 0)

        # pre-order ALL static per-cell data by (shell, slot) at setup, so
        # the scan consumes contiguous xs slices instead of paying a
        # dynamic gather per array per step (the packed layout leaves only
        # the unavoidable dynamic ones: 1-4 column gathers + the dtau
        # gather + the scatter)
        safe_np = np.where(shell_idx >= 0, shell_idx, 0)

        def pack_i(a):
            return jnp.asarray(a.ravel().astype(np.int32)[safe_np])

        def pack_f(a):
            # the config's precision, also when x64 is on for another run
            return jnp.asarray(np.asarray(a).ravel()[safe_np],
                               dtype=cfg.np_dtype)

        self._c1s = pack_i(self.c1)
        self._c2s = pack_i(self.c2) if nd >= 2 else None
        self._c3s = pack_i(self.c3) if nd == 3 else None
        self._c4s = pack_i(self.c4) if nd == 3 else None
        self._d0s = pack_f(self.delta0) if nd >= 2 else None
        self._d1s = pack_f(self.delta1) if nd == 3 else None
        self._oas = jnp.asarray(on_axis.ravel()[safe_np])
        self._corrs = pack_f(self.axis_corr)

    def trace(self, dtau: jnp.ndarray):
        """Run the shell scan.  ``dtau``: per-cell optical depth increment.
        Returns ``tau_entry`` (optical depth to the cell's entry point)."""
        nd = self.cfg.ndim
        dtau_f = dtau.ravel()
        ncell = dtau_f.shape[0]
        # one extra dummy slot absorbs the padded-lane scatters, so real
        # cells never see a duplicate-index write
        col0 = jnp.zeros(ncell + 1, dtype=dtau_f.dtype)
        tmin = self.tau_min

        if nd == 1:
            xs = (self.shell_idx, self.shell_mask, self._c1s,
                  self._oas, self._corrs)
        elif nd == 2:
            xs = (self.shell_idx, self.shell_mask, self._c1s, self._c2s,
                  self._d0s, self._oas, self._corrs)
        else:
            xs = (self.shell_idx, self.shell_mask, self._c1s, self._c2s,
                  self._c3s, self._c4s, self._d0s, self._d1s,
                  self._oas, self._corrs)

        def shell_step(col, args):
            if nd == 1:
                idx, mask, i1, oa, corr = args
            elif nd == 2:
                idx, mask, i1, i2, d0, oa, corr = args
            else:
                idx, mask, i1, i2, i3, i4, d0, d1, oa, corr = args
            safe = jnp.where(idx >= 0, idx, 0)
            c1 = col[i1]
            if nd == 1:
                tau_in = c1
            elif nd == 2:
                c2 = col[i2]
                w1 = (1.0 - d0) / jnp.maximum(tmin, c1)
                w2 = d0 / jnp.maximum(tmin, c2)
                tau_in = (w1 * c1 + w2 * c2) / (w1 + w2)
            else:
                c2 = col[i2]
                c3 = col[i3]
                c4 = col[i4]
                w1 = (1.0 - d0) * (1.0 - d1) / jnp.maximum(tmin, c1)
                w2 = d0 * (1.0 - d1) / jnp.maximum(tmin, c2)
                w3 = (1.0 - d0) * d1 / jnp.maximum(tmin, c3)
                w4 = d0 * d1 / jnp.maximum(tmin, c4)
                tau_in = (w1 * c1 + w2 * c2 + w3 * c3 + w4 * c4) / (
                    w1 + w2 + w3 + w4)
            # on-axis cells: entry neighbor's column with geometric factor
            tau_in = jnp.where(oa, c1 * corr, tau_in)
            new_col = tau_in + dtau_f[safe]
            target = jnp.where(mask, safe, ncell)
            col = col.at[target].set(new_col, mode="drop")
            return col, None

        col, _ = jax.lax.scan(shell_step, col0, xs)
        tau_entry = col[:ncell] - dtau_f
        return tau_entry.reshape(dtau.shape)


class PointSourcePlaneTracer:
    """Cube-shell (L-inf) plane-sweep point-source tracer.

    Same C2Ray interpolation as :class:`PointSourceTracer`, reorganized
    as dense plane operations: instead of 3N sequential L1 shells of
    gather/scatter work, the sweep scans Chebyshev
    shells max(|di|,|dj|,|dk|) = m — at most max(N_a) steps — and each
    step updates the 6 (2D: 4) cube faces as DENSE plane operations:
    one dynamic_slice of the plane one step closer to the source, per-cell
    perp shifts expressed as rolls + static sign masks, and one
    dynamic_update_slice back.  No dynamic gathers at all; under GSPMD the
    rolls lower to collective-permutes (the causal-pipeline equivalent of
    the reference's raytracer_SC_pllel.cpp:156-221).

    Correct ordering: a face cell's upstream neighbors (c1..c4) sit either
    in shell m-1 or — for edge/corner cells, whose major-axis preference
    is x>y>z — in a LOWER-preference face of the same shell; updating the
    faces in ascending array-axis order (z, then y, then x) therefore
    satisfies every dependency (values are bitwise the ones the L1-shell
    scan computes, since each cell applies the same formula to the same
    upstream cells)."""

    def __init__(self, cfg: SimConfig, geom: Geometry, pos: Tuple[float, ...],
                 tau_min: float = 0.7):
        self.cfg = cfg
        self.tau_min = tau_min * (6.0 / 7.0 if cfg.ndim == 3 else 1.0)
        nd = cfg.ndim
        assert nd >= 2, "plane sweep needs >= 2 dimensions (1D: shell scan)"
        shape = cfg.shape
        dx = geom.dx
        ng = cfg.ng

        centers = [g.pos[ng:-ng] for g in geom.axes]
        src_idx = [int(np.clip(np.argmin(np.abs(centers[a] - pos[a])),
                               0, shape[a] - 1)) for a in range(nd)]
        self.src_idx = tuple(src_idx)
        self.src_pos = np.array([centers[a][src_idx[a]] for a in range(nd)])

        grids = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
        d = [g - s for g, s in zip(grids, src_idx)]
        ad = [np.abs(x) for x in d]
        p = sum(ad)
        order = list(range(nd - 1, -1, -1))  # prefer x, then y, then z
        maj = np.full(shape, order[0])
        best = ad[order[0]].copy()
        for a in order[1:]:
            take = ad[a] > best
            maj = np.where(take, a, maj)
            best = np.where(take, ad[a], best)

        with np.errstate(divide="ignore", invalid="ignore"):
            deltas = [np.where(best > 0, adk / np.maximum(best, 1), 0.0)
                      for adk in ad]
        sum_d2 = sum(dk * dk for dk in deltas) - 1.0
        ds = dx * np.sqrt(1.0 + np.maximum(sum_d2, 0.0))
        ds = np.where(p == 0, 0.5 * dx, ds)
        self.ds = ds
        r_cell = np.sqrt(sum((dd * dx) ** 2 for dd in d))
        rs = np.maximum(r_cell - 0.5 * ds, 0.0)
        self.vshell = 4.0 * np.pi * ((rs + ds) ** 3 - rs**3) / 3.0

        # interpolation deltas aligned to each cell's major axis: first =
        # lowest non-major axis, second = the other (3D)
        if nd == 2:
            mino = np.minimum(ad[0], ad[1])
            delta0 = np.where(best > 0, mino / np.maximum(best, 1), 0.0)
            delta1 = np.zeros_like(delta0)
        else:
            firsts, seconds = [], []
            for a in range(nd):
                others = [b for b in range(nd) if b != a]
                firsts.append(others[0])
                seconds.append(others[1])
            first_ax = np.choose(maj, firsts)
            second_ax = np.choose(maj, seconds)
            delta0 = np.choose(first_ax, deltas)
            delta1 = np.choose(second_ax, deltas)

        if nd == 2:
            min_off = np.minimum(ad[0], ad[1])
        else:
            min_off = np.sort(np.stack(ad), axis=0)[1]
        on_axis = (min_off == 0) & (p > 0)
        m = best.astype(float)
        with np.errstate(divide="ignore", invalid="ignore"):
            corr = np.sqrt((m * m + 0.25) / ((m - 1) ** 2 + 0.25)) * \
                np.where(m > 0, (m - 1) / np.maximum(m, 1), 0.0)
        corr = np.where((m < 10) & (m >= 1), corr, 1.0)

        self._maj_mask = [jnp.asarray(maj == a) for a in range(nd)]
        # the config's precision, also when x64 is on for another run
        fdt = cfg.np_dtype
        self._delta0 = jnp.asarray(delta0, dtype=fdt)
        self._delta1 = jnp.asarray(delta1, dtype=fdt)
        self._on_axis = jnp.asarray(on_axis)
        self._corr = jnp.asarray(np.where(on_axis, corr, 1.0), dtype=fdt)
        # per-axis offset signs as broadcastable 1D arrays
        self._sgn1d = []
        for a in range(nd):
            s1 = np.sign(np.arange(shape[a]) - src_idx[a]).astype(np.int8)
            sh = [1] * nd
            sh[a] = shape[a]
            self._sgn1d.append(jnp.asarray(s1.reshape(sh)))
        self.n_steps = int(max(max(src_idx[a], shape[a] - 1 - src_idx[a])
                               for a in range(nd)))

    @staticmethod
    def _shift_toward(arr, sgn_b, axis):
        """Per-cell neighbor value one step toward the source along
        ``axis``: out[i] = arr[i - sgn(i)] (sgn constant along the other
        axes, so the composition of per-axis selections is exact)."""
        plus = jnp.roll(arr, 1, axis)    # arr[i-1]
        minus = jnp.roll(arr, -1, axis)  # arr[i+1]
        return jnp.where(sgn_b > 0, plus, jnp.where(sgn_b < 0, minus, arr))

    def trace(self, dtau: jnp.ndarray):
        """Returns tau_entry (optical depth to each cell's entry point)."""
        nd = self.cfg.ndim
        shape = self.cfg.shape
        src = self.src_idx
        tmin = self.tau_min
        col0 = jnp.zeros_like(dtau)
        col0 = col0.at[src].set(dtau[src])

        def face_pass(col, a, s, m_):
            n_a = shape[a]
            idx = src[a] + s * m_
            valid = (idx >= 0) & (idx <= n_a - 1)
            idx_c = jnp.clip(idx, 0, n_a - 1)
            prev_c = jnp.clip(idx - s, 0, n_a - 1)
            prev = jax.lax.dynamic_slice_in_dim(col, prev_c, 1, axis=a)
            cur = jax.lax.dynamic_slice_in_dim(col, idx_c, 1, axis=a)

            def sl(arr):
                return jax.lax.dynamic_slice_in_dim(arr, idx_c, 1, axis=a)

            mask = sl(self._maj_mask[a])
            dt_pl = sl(dtau)
            d0 = sl(self._delta0)
            oa = sl(self._on_axis)
            corr = sl(self._corr)
            perp = [b for b in range(nd) if b != a]
            c1 = prev
            if nd == 2:
                p1 = perp[0]
                s1 = jax.lax.dynamic_slice_in_dim(
                    jnp.broadcast_to(self._sgn1d[p1], shape), idx_c, 1,
                    axis=a)
                c2 = self._shift_toward(prev, s1, p1)
                w1 = (1.0 - d0) / jnp.maximum(tmin, c1)
                w2 = d0 / jnp.maximum(tmin, c2)
                tau_in = (w1 * c1 + w2 * c2) / (w1 + w2)
            else:
                p1, p2 = perp  # ascending: first = lowest non-major axis
                d1 = sl(self._delta1)
                s1 = jax.lax.dynamic_slice_in_dim(
                    jnp.broadcast_to(self._sgn1d[p1], shape), idx_c, 1,
                    axis=a)
                s2 = jax.lax.dynamic_slice_in_dim(
                    jnp.broadcast_to(self._sgn1d[p2], shape), idx_c, 1,
                    axis=a)
                c2 = self._shift_toward(prev, s1, p1)
                c3 = self._shift_toward(prev, s2, p2)
                c4 = self._shift_toward(c2, s2, p2)
                w1 = (1.0 - d0) * (1.0 - d1) / jnp.maximum(tmin, c1)
                w2 = d0 * (1.0 - d1) / jnp.maximum(tmin, c2)
                w3 = (1.0 - d0) * d1 / jnp.maximum(tmin, c3)
                w4 = d0 * d1 / jnp.maximum(tmin, c4)
                tau_in = (w1 * c1 + w2 * c2 + w3 * c3 + w4 * c4) / (
                    w1 + w2 + w3 + w4)
            tau_in = jnp.where(oa, c1 * corr, tau_in)
            new = tau_in + dt_pl
            plane = jnp.where(mask & valid, new, cur)
            return jax.lax.dynamic_update_slice_in_dim(col, plane, idx_c,
                                                       axis=a)

        def shell_step(col, m_):
            # ascending axis order satisfies the edge/corner dependencies
            for a in range(nd):
                for s in (-1, 1):
                    col = face_pass(col, a, s, m_)
            return col, None

        col, _ = jax.lax.scan(shell_step, col0,
                              jnp.arange(1, self.n_steps + 1))
        return col - dtau


class Raytracer:
    """Per-step driver: computes the rt dict each chemistry module consumes
    (the RayTrace_SingleSource + rt_source_data assembly equivalent,
    reference: sim_init.cpp:806 RT_all_sources)."""

    def __init__(self, cfg: SimConfig, geom: Geometry, sources):
        self.cfg = cfg
        self.geom = geom
        self.sources = list(sources)
        self.point_tracers = {}
        for i, s in enumerate(self.sources):
            if not s.at_infinity:
                # 2D/3D: dense plane sweep (no dynamic gathers); 1D keeps
                # the L1-shell scan (already two trivial directional rays)
                cls = (PointSourcePlaneTracer if cfg.ndim >= 2
                       else PointSourceTracer)
                self.point_tracers[i] = cls(cfg, geom, s.position,
                                            s.tau_min)

    def trace_source(self, i: int, dtau: jnp.ndarray):
        s = self.sources[i]
        if s.at_infinity:
            return parallel_rays(dtau, s.axis, s.sign, self.geom.dx)
        tr = self.point_tracers[i]
        tau = tr.trace(dtau)
        vs = tr.vshell
        if not jax.config.jax_enable_x64:
            # raw shell volumes (~1e51 cm^3) overflow f32; rate factors use
            # the host-precomputed Ndot/Vshell instead (physics.raytrace),
            # so the clipped value is only a diagnostic
            vs = np.minimum(vs, 3.0e38)
        return tau, jnp.asarray(tr.ds), jnp.asarray(vs)
