"""Interactive cell inspector (the debugger the reference builds in
TESTING mode).

JAX equivalent of the reference's gdb-like command-line cell
debugger (reference: source/tools/command_line_interface.cpp:54-188 —
``fpt``/``lpt``/``next_point(dir)``/``end_of_col(dir)``/``print_cell``,
plus a shell escape).  The pointer-walk over linked-list cells becomes a
cursor into the dense state array; directions use the reference's
``XN/XP/YN/YP/ZN/ZP`` names.  Drive it programmatically (the methods) or
interactively (:meth:`CellInspector.repl`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .config import SimConfig

# direction name -> (physical axis index k, step)
_DIRS = {
    "XN": (0, -1), "XP": (0, +1),
    "YN": (1, -1), "YP": (1, +1),
    "ZN": (2, -1), "ZP": (2, +1),
}

_VAR_NAMES = ["rho", "pg", "vx", "vy", "vz", "bx", "by", "bz", "psi"]


class CellInspector:
    """Cursor-based inspector over a snapshot's dense state array."""

    def __init__(self, P, cfg: SimConfig, t: float = 0.0):
        self.P = np.asarray(P)
        self.cfg = cfg
        self.t = t
        self.idx: Tuple[int, ...] = (0,) * cfg.ndim  # array-order index

    # -- navigation (reference: command_line_interface.cpp:140-156) --------
    def fpt(self):
        """Move to the first grid point."""
        self.idx = (0,) * self.cfg.ndim
        return self.idx

    def lpt(self):
        """Move to the last grid point."""
        self.idx = tuple(n - 1 for n in self.cfg.shape)
        return self.idx

    def _axis_of(self, direction: str) -> Tuple[int, int]:
        d = direction.upper()
        if d not in _DIRS:
            raise ValueError(f"unknown direction {direction!r} "
                             f"(use {'/'.join(_DIRS)})")
        k, step = _DIRS[d]
        if k >= self.cfg.ndim:
            raise ValueError(f"direction {d} outside a {self.cfg.ndim}D grid")
        ax = self.cfg.ndim - 1 - k  # physical axis k -> array axis
        return ax, step

    def next_point(self, direction: str):
        """Step one cell in XN/XP/YN/YP/ZN/ZP; clamps at the grid edge."""
        ax, step = self._axis_of(direction)
        idx = list(self.idx)
        idx[ax] = int(np.clip(idx[ax] + step, 0, self.cfg.shape[ax] - 1))
        self.idx = tuple(idx)
        return self.idx

    def end_of_col(self, direction: str):
        """Run to the grid edge along a direction."""
        ax, step = self._axis_of(direction)
        idx = list(self.idx)
        idx[ax] = self.cfg.shape[ax] - 1 if step > 0 else 0
        self.idx = tuple(idx)
        return self.idx

    def goto(self, *idx: int):
        """Jump to an array-order cell index."""
        if len(idx) != self.cfg.ndim:
            raise ValueError(f"need {self.cfg.ndim} indices")
        for i, n in zip(idx, self.cfg.shape):
            if not 0 <= i < n:
                raise ValueError(f"index {idx} outside grid {self.cfg.shape}")
        self.idx = tuple(int(i) for i in idx)
        return self.idx

    # -- inspection ---------------------------------------------------------
    def position(self) -> Tuple[float, ...]:
        """Physical (x, y, z[, ...]) cell-centre position."""
        pos = []
        for ax, i in enumerate(self.idx):
            k = self.cfg.ndim - 1 - ax
            pos.append(self.cfg.xmin[k] + (i + 0.5) * self.cfg.dx)
        return tuple(reversed(pos))

    def state(self) -> np.ndarray:
        """Primitive vector of the current cell."""
        return self.P[(slice(None),) + self.idx]

    def print_cell(self, out=print):
        """Formatted dump of the current cell (the reference's print_cell)."""
        vals = self.state()
        names = _VAR_NAMES[: self.cfg.eqn.nbase] + [
            f"tr{i}" for i in range(self.cfg.ntracer)]
        out(f"cell idx={self.idx} pos={tuple(f'{p:.6g}' for p in self.position())}")
        for n, v in zip(names, vals):
            out(f"  {n:>4s} = {v: .9e}")
        return dict(zip(names, map(float, vals)))

    def minmax(self, out=print):
        """Per-variable global min/max (quick NaN/outlier hunting)."""
        names = _VAR_NAMES[: self.cfg.eqn.nbase] + [
            f"tr{i}" for i in range(self.cfg.ntracer)]
        res = {}
        for v, n in enumerate(names):
            a = self.P[v]
            res[n] = (float(np.nanmin(a)), float(np.nanmax(a)),
                      int(np.sum(~np.isfinite(a))))
            out(f"  {n:>4s}: min={res[n][0]: .6e} max={res[n][1]: .6e}"
                f" nonfinite={res[n][2]}")
        return res

    # -- interactive loop (reference: :83-188) ------------------------------
    def repl(self, input_fn=input, out=print):  # pragma: no cover - wrapper
        out('cell inspector - type "help"')
        while True:
            try:
                line = input_fn("dbg> ").strip()
            except EOFError:
                return
            if not line:
                continue
            cmd, *args = line.split()
            if cmd in ("q", "quit", "exit"):
                return
            try:
                if cmd == "help":
                    out("fpt | lpt | next_point DIR | end_of_col DIR | "
                        "goto I [J [K]] | print_cell | minmax | quit")
                elif cmd == "fpt":
                    out(str(self.fpt()))
                elif cmd == "lpt":
                    out(str(self.lpt()))
                elif cmd == "next_point":
                    out(str(self.next_point(args[0])))
                elif cmd == "end_of_col":
                    out(str(self.end_of_col(args[0])))
                elif cmd == "goto":
                    out(str(self.goto(*map(int, args))))
                elif cmd == "print_cell":
                    self.print_cell(out)
                elif cmd == "minmax":
                    self.minmax(out)
                else:
                    out(f"unknown command: {cmd}")
            except Exception as e:  # keep the loop alive like the reference
                out(f"error: {e}")


def inspect_snapshot(path: str) -> CellInspector:
    """Open a snapshot file in the inspector."""
    from .io import load_snapshot

    cfg, P, t, _step = load_snapshot(path)
    return CellInspector(P, cfg, t)


if __name__ == "__main__":  # pragma: no cover
    import sys

    inspect_snapshot(sys.argv[1]).repl()
