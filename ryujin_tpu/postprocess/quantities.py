"""Time-series statistics of quantities of interest on manifolds.

Analog of /root/reference/source/quantities.template.h: the
reference accumulates space-averaged, time-averaged, and instantaneous
primitive quantities (first and second moments) over interior and boundary
manifolds defined by muparser level-set expressions.  Here manifolds are
configured as python expressions over the nodal coordinates; nodes with
expression >= 0 belong to the manifold.

Manifold config rows are ``[name, expression]`` or
``[name, expression, options]`` where options is a string containing any
of ``space_averaged`` (default), ``time_averaged``, ``instantaneous``:

  * space_averaged: per tick, one line of mass-weighted means and second
    moments appended to ``<basename>-<name>.dat``
    (quantities.template.h:512-580).
  * instantaneous: per write-out cycle, the per-node primitive values to
    ``<basename>-<name>-R<cycle>-instantaneous.dat``
  * time_averaged: trapezoidal running average written to
    ``<basename>-<name>-R<cycle>-time_averaged.dat``; the statistics are
    reset afterwards if ``clear statistics on writeout`` is set
    (quantities.template.h:82-86).

Boundary manifolds select boundary dofs (weights = boundary mass);
interior manifolds select all real nodes (weights = lumped mass).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..config import QuantitiesConfig


def _levelset_env(pos: np.ndarray):
    names = {"x": pos[:, 0]}
    if pos.shape[1] >= 2:
        names["y"] = pos[:, 1]
    if pos.shape[1] >= 3:
        names["z"] = pos[:, 2]
    env = {"__builtins__": {}, "np": np}
    env.update(
        {k: getattr(np, k) for k in (
            "sin", "cos", "exp", "sqrt", "abs", "minimum", "maximum", "pi",
        )}
    )
    env.update(names)
    return env


class _Manifold:
    def __init__(self, name, options, idx, weights, positions):
        self.name = name
        self.options = options
        self.idx = idx  # node indices
        self.weights = weights  # normalized
        self.positions = positions
        # temporal statistics (val_sum is a trapezoidal time integral):
        self.t_old = None
        self.val_old = None
        self.val_sum = None
        self.t_sum = 0.0


class Quantities:
    def __init__(self, eq, packed, cfg: QuantitiesConfig, basename: str):
        self.eq = eq
        self.packed = packed
        self.basename = basename
        self.clear_on_writeout = getattr(
            cfg, "clear_statistics_on_writeout", True
        )
        self.manifolds: List[_Manifold] = []

        pos = packed.positions
        env = _levelset_env(pos)
        mask = packed.node_mask > 0

        for row in cfg.manifolds:
            name, expr = row[0], row[1]
            options = row[2] if len(row) > 2 else "space_averaged"
            sel = np.asarray(
                eval(expr, dict(env)) >= 0  # noqa: S307 (config file)
            ) & mask
            idx = np.flatnonzero(sel)
            if len(idx) == 0:
                raise ValueError(f"manifold '{name}' selects no nodes")
            w = packed.lumped_mass[idx]
            self._add(name, options, idx, w, pos[idx])

        for row in getattr(cfg, "boundary_manifolds", ()) or ():
            name, expr = row[0], row[1]
            options = row[2] if len(row) > 2 else "space_averaged"
            idx_list, w_list, pos_list = [], [], []
            for rnd in packed.boundary_rounds:
                for g in rnd.values():
                    lvl = np.asarray(
                        eval(expr, dict(_levelset_env(g.position)))  # noqa: S307
                    )
                    lvl = np.broadcast_to(lvl, (len(g.index),))
                    keep = lvl >= 0
                    idx_list.append(g.index[keep])
                    w_list.append(g.boundary_mass[keep])
                    pos_list.append(g.position[keep])
            idx = np.concatenate(idx_list) if idx_list else np.zeros(0, int)
            if len(idx) == 0:
                raise ValueError(
                    f"boundary manifold '{name}' selects no boundary dofs"
                )
            self._add(name, options, idx,
                      np.concatenate(w_list), np.concatenate(pos_list))

    def _add(self, name, options, idx, w, positions):
        m = _Manifold(name, options, idx, w / w.sum(), positions)
        self.manifolds.append(m)
        if "space_averaged" in options:
            names = self.eq.primitive_component_names
            open(self._fname(name), "w").write(
                "# t " + " ".join(names)
                + " " + " ".join(n + "^2" for n in names) + "\n"
            )

    def _fname(self, name):
        return f"{self.basename}-{name}.dat"

    def _primitive(self, U):
        import jax.numpy as jnp

        return np.asarray(self.eq.to_primitive_state(jnp.asarray(U)))

    def accumulate(self, U, t: float) -> None:
        """Per-tick accumulation (quantities.template.h accumulate())."""
        if not self.manifolds:
            return
        prim = self._primitive(U)
        for m in self.manifolds:
            vals = prim[:, m.idx]  # [C, k]
            if "space_averaged" in m.options:
                means = vals @ m.weights
                seconds = (vals * vals) @ m.weights
                with open(self._fname(m.name), "a") as f:
                    f.write(
                        f"{t:.10e} "
                        + " ".join(f"{v:.10e}" for v in means) + " "
                        + " ".join(f"{v:.10e}" for v in seconds) + "\n"
                    )
            if "time_averaged" in m.options:
                if m.t_old is not None and t > m.t_old:
                    dt = t - m.t_old
                    if m.val_sum is None:
                        m.val_sum = np.zeros_like(vals)
                    m.val_sum += 0.5 * dt * (m.val_old + vals)
                    m.t_sum += dt
                m.t_old = t
                m.val_old = vals

    def state_dict(self) -> dict:
        """Time-average accumulator state for checkpointing."""
        out = {}
        for i, m in enumerate(self.manifolds):
            if m.t_old is None:
                continue
            out[f"q{i}_t_old"] = np.float64(m.t_old)
            out[f"q{i}_t_sum"] = np.float64(m.t_sum)
            out[f"q{i}_val_old"] = m.val_old
            if m.val_sum is not None:
                out[f"q{i}_val_sum"] = m.val_sum
        return out

    def load_state(self, state: dict) -> None:
        for i, m in enumerate(self.manifolds):
            if f"q{i}_t_old" in state:
                m.t_old = float(state[f"q{i}_t_old"])
                m.t_sum = float(state[f"q{i}_t_sum"])
                m.val_old = np.asarray(state[f"q{i}_val_old"])
                if f"q{i}_val_sum" in state:
                    m.val_sum = np.asarray(state[f"q{i}_val_sum"])

    def write_out(self, U, t: float, cycle: int) -> None:
        """Per-cycle field output (quantities.template.h write_out())."""
        prim = None
        for m in self.manifolds:
            prefix = f"{self.basename}-{m.name}-R{cycle:04d}"
            needs_fields = (
                "instantaneous" in m.options or "time_averaged" in m.options
            )
            if not needs_fields:
                continue
            # points/mass file (write_mesh_files analog):
            with open(f"{prefix}-points.dat", "w") as f:
                f.write("#\n# position\tmass\n")
                for x, w in zip(m.positions, m.weights):
                    f.write(" ".join(f"{v:.14e}" for v in x)
                            + f"\t{w:.14e}\n")
            if "instantaneous" in m.options:
                if prim is None:
                    prim = self._primitive(U)
                self._write_field(
                    f"{prefix}-instantaneous.dat", f"# at t = {t:.14e}\n",
                    prim[:, m.idx], 1.0,
                )
            if "time_averaged" in m.options and m.t_sum > 0.0:
                self._write_field(
                    f"{prefix}-time_averaged.dat",
                    f"# averaged from t = {m.t_old - m.t_sum:.14e} "
                    f"to t = {m.t_old:.14e}\n",
                    m.val_sum, 1.0 / m.t_sum,
                )
                if self.clear_on_writeout:
                    m.val_sum = None
                    m.t_sum = 0.0

    def _write_field(self, fname, stamp, vals, scale):
        names = self.eq.primitive_component_names
        with open(fname, "w") as f:
            f.write(stamp)
            f.write("# primitive state (" + ", ".join(names) + ")\n")
            for col in range(vals.shape[1]):
                f.write(
                    " ".join(f"{scale * v:.14e}" for v in vals[:, col]) + "\n"
                )
