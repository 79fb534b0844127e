"""Common microphysics interface utilities.

The reference defines the module interface in microphysics_base
(reference: source/microphysics/microphysics_base.h:52-318): TimeUpdateMP /
TimeUpdateMP_RTnew, timescales(_RT), Temperature, Set_Temp.  Here the
interface is duck-typed (update / timescales / temperature / set_temp) and
:class:`JitCachedMP` supplies jit-compiled dispatch for modules that
implement ``_update_impl`` / ``cell_timescales``.
"""
from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from ..config import SimConfig


def min_timescale(t, exclude=None):
    """Smallest per-cell timescale, skipping the cells in ``exclude``
    (internal-boundary cells such as a wind region: the reference's
    microphysics dt loops skip ``c->isbd`` cells, calc_timestep.cpp
    get_mp_timescales_with_radiation / _no_radiation)."""
    if exclude is not None:
        t = jnp.where(exclude, jnp.inf, t)
    return jnp.min(t)


class JitCachedMP:
    """Mixin: jit the heavy entry points once per (shape, dtype, cfg)."""

    # absolute primitive-vector indices of ELEMENT mass-fraction tracers
    # (reference: microphysics_base el_index); the sCMA corrector
    # renormalizes these to sum to 1 at the advection edge states
    # (microphysics_base.cpp:96-118).  Empty for the implemented
    # single-ion H modules; multi-element modules must declare theirs.
    element_slots: tuple = ()

    def _timescales_impl(self, P, cfg: SimConfig, rt: Dict, exclude=None):
        return min_timescale(self.cell_timescales(P, cfg, rt), exclude)

    def _jits(self):
        if not hasattr(self, "_jit_cache"):
            self._jit_cache = {
                "update": jax.jit(self._update_impl, static_argnames=("cfg",)),
                "timescales": jax.jit(self._timescales_impl,
                                      static_argnames=("cfg",)),
            }
        return self._jit_cache

    def update(self, P, dt, cfg: SimConfig, rt: Optional[Dict] = None):
        if rt is None:
            rt = self.default_rt(P)
        return self._jits()["update"](P, dt, cfg, rt)

    def timescales(self, P, cfg: SimConfig, rt: Optional[Dict] = None):
        if rt is None:
            rt = self.default_rt(P)
        return self._jits()["timescales"](P, cfg, rt)
