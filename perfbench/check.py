"""What decides `correct`: the program's answers in the window, held to the
configuration's guarantees and to the plain reference.

Every period of the window: the commands are finite, a broken thruster is
commanded exactly 0 and every command lies in [0, max_thrust] (exact
comparisons, limit 0), from the copy the flight computer receives.

A sample of the periods, drawn from the seed (the first period always, the
rest by reservoir sampling over the window): the reference computes the
same control step from the same inputs, and the program's thruster
commands (u) and SQP iterate (U: the whole horizon of input deviations,
what the QP solutions built) are compared row by row, each row by its
largest difference.  Medians are upper medians (of an even count, the
higher middle), so a fault on exactly half the rows reads a faulty row:
  * u_gap_p50, U_gap_p50: the median over the bank's rows;
  * u_gap_pattern_max, U_gap_pattern_max: the largest, over the bank's fault
    patterns, of the median over that pattern's rows (a fault in one
    pattern's rows, a minority of the bank);
  * u_gap_cleanup_p50, U_gap_cleanup_p50: the median over the rows that the
    reference's worst-K cleanup re-solved (an eighth of the bank).
The first period starts from the reference's own warm start; a later one
follows the program's warm start as it entered that period (its duals, rho
and metric inverse are the program's state), and that carry is checked by
itself: the warm start the period received is the previous period's,
shifted one stage (limit 0).  Where the program carries the duals of
another number of dense rows than the configuration's QP has (terminal
rows, then its state box's and wrench rate's rows), it has dropped or added
a bound; the reference cannot follow that state, and the period's gaps read
inf.
"""

from __future__ import annotations

import math
import random
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import reference as ref

GAPS = tuple(f"{n}_gap_{k}" for n in ("u", "U") for k in ("p50", "pattern_max", "cleanup_p50"))


class Guarantees:
    """The configuration's guarantees on every period's commands (host copy)."""

    def __init__(self, broken: np.ndarray, max_thrust: float):
        self.broken, self.ub = broken > 0.5, np.where(broken > 0.5, 0.0, max_thrust)
        self.nonfinite, self.broken_max, self.bound_excess, self.failed = 0, 0.0, 0.0, 0

    def see(self, u: np.ndarray) -> None:
        u = u.astype(np.float64)
        bad = int((~np.isfinite(u)).sum())
        broken = float(np.abs(np.where(self.broken, u, 0.0)).max())
        over = float(np.maximum(np.maximum(u - self.ub, -u), 0.0).max()) if bad == 0 else math.inf
        self.nonfinite += bad
        self.broken_max = max(self.broken_max, broken if bad == 0 else math.inf)
        self.bound_excess = max(self.bound_excess, over)
        self.failed += int(bad > 0 or broken > 0 or over > 0)

    def numbers(self) -> dict:
        return {"nonfinite": float(self.nonfinite), "broken_cmd_max": self.broken_max,
                "bound_excess": self.bound_excess}


class Sample:
    """Reservoir sampling of periods 1, 2, ... (period 0 is always kept)."""

    def __init__(self, seed: int, k: int):
        self.rng, self.k, self.seen, self.kept = random.Random(seed), k, 0, {}

    def wants(self, p: int) -> int | None:
        """The slot period p would take, or None; call once a period, in order."""
        if p == 0:
            return 0
        self.seen += 1
        if self.k <= 1:
            return None
        if self.seen < self.k:
            return self.seen
        j = self.rng.randrange(self.seen)
        return 1 + j if j < self.k - 1 else None


def snapshot(p, x, window_start, warm_in, prev_warm, out):
    clone = lambda w: None if w is None else SimpleNamespace(
        **{k: None if getattr(w, k) is None else getattr(w, k).clone()
           for k in ("X", "U", "y_hull", "y_term", "rho", "kinv")})
    return SimpleNamespace(p=p, x=x.clone(), start=window_start,
                           warm_in=None if p == 0 else clone(warm_in),
                           prev=None if p == 0 else clone(prev_warm),
                           u=out.u_phys.clone(), U=out.warm.U.clone())


def carry_gap(s) -> float:
    """The largest difference between the warm start period p received and
    the previous period's, shifted one stage (X's first row, the new state,
    is the program's own and left out)."""
    sh = lambda t: torch.cat([t[:, 1:], t[:, -1:]], 1)
    pairs = [(s.warm_in.X[:, 1:], torch.cat([s.prev.X[:, 2:], s.prev.X[:, -1:]], 1)),
             (s.warm_in.U, sh(s.prev.U)), (s.warm_in.y_hull, sh(s.prev.y_hull)),
             (s.warm_in.y_term, s.prev.y_term), (s.warm_in.rho, s.prev.rho)]
    if s.warm_in.kinv is not None:
        pairs.append((s.warm_in.kinv, s.prev.kinv))
    return max(float((a.double() - b.double()).abs().max()) for a, b in pairs)


def p50(x: torch.Tensor) -> float:
    """The upper median (0 for no rows)."""
    return float(x.sort().values[x.numel() // 2]) if x.numel() else 0.0


def judge(u, U, r, rows: torch.Tensor) -> dict:
    """The comparison numbers of one period's answers (u, U) against the
    reference step r; rows[i] is the fault pattern of bank row i."""
    du = (u.double() - r.u_phys.double()).abs().amax(1)
    dU = (U.double() - r.warm.U.double()).abs().amax((1, 2))
    bad = ~torch.isfinite(du) | ~torch.isfinite(dU)
    du, dU = torch.where(bad, math.inf, du).cpu(), torch.where(bad, math.inf, dU).cpu()
    rows, cleaned = rows.cpu(), r.info.cleaned.cpu()
    out = {}
    for name, d in (("u", du), ("U", dU)):
        out[f"{name}_gap_p50"] = p50(d)
        out[f"{name}_gap_pattern_max"] = max(p50(d[rows == p]) for p in rows.unique())
        out[f"{name}_gap_cleanup_p50"] = p50(d[cleaned])
    return out


class Reference:
    """The reference of one cell, built once after the window."""

    def __init__(self, config, traffic, root, device, dtype=torch.float64):
        from perfbench import cell as cells

        self.dtype, self.device = dtype, device
        plant = ref.plant_constants(config["plant"])
        pad = config["padding"]
        self.B = traffic["batch"]
        rows = cells.bank_rows(traffic)
        self.rows = torch.as_tensor(rows)
        self.bank = ref.build_bank(plant, traffic["patterns"], rows,
                                   config["terminal"]["tuning"], root / config["terminal"]["cache_dir"],
                                   pad["hull_facets"], pad["terminal_rows"], device, dtype)
        self.pl = ref.plant_tensors(plant, device, dtype)
        bounds = cells.weight_bounds(config)
        if config["mpc"]["qp_backend"] == "stagewise":
            for k, v in bounds.items():
                if v is not None:
                    raise ValueError(f"weights: {k} on the stagewise backend; the reference "
                                     "builds the state box and the rate rows on the condensed "
                                     "backend only")
        t = lambda v: None if v is None else torch.as_tensor(v, dtype=dtype, device=device)
        self.W = SimpleNamespace(Q=torch.diag(t(config["weights"]["Q"])),
                                 R=torch.diag(t(config["weights"]["R"])),
                                 **{k: t(v) for k, v in bounds.items()})
        self.cfg = cells.reference_cfg(config, self.B)
        self.dense_rows = pad["terminal_rows"] + ref.n_extra(self.W, self.cfg.horizon)

    def step(self, s, x_ref, u_ref):
        """The reference's control step for snapshot s, from its own first
        warm start (period 0) or the program's warm start as it entered."""
        c = lambda t: None if t is None else t.to(device=self.device, dtype=self.dtype)
        x, xr, ur = c(s.x), c(x_ref), c(u_ref)
        if s.warm_in is None:
            warm = ref.init_warm(self.pl, self.bank, self.W, self.cfg,
                                 ref.robot_to_center(self.bank.r, x), xr, ur)
        else:
            warm = SimpleNamespace(**{k: c(getattr(s.warm_in, k))
                                      for k in ("X", "U", "y_hull", "y_term", "rho", "kinv")})
        return ref.control_step(self.pl, self.bank, self.W, self.cfg, x, xr, ur, warm)


def compare(samples, reference, x_ref_full, u_ref_full, horizon) -> dict:
    """The largest of each comparison number over the sampled periods."""
    worst = {"carry_gap": 0.0}
    for s in samples:
        win = slice(s.start, s.start + horizon + 1)
        if s.warm_in is not None and s.warm_in.y_term.shape[1] != reference.dense_rows:
            got = dict.fromkeys(GAPS, math.inf)
        else:
            r = reference.step(s, x_ref_full[win], u_ref_full[win])
            got = judge(s.u, s.U, r, reference.rows)
        if s.warm_in is not None:
            got["carry_gap"] = carry_gap(s)
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), v) if not math.isnan(v) else math.inf
    return worst
