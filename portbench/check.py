"""The comparison that decides ``correct``: the program's first rounds
against the reference's, by norms of the worst leaf.

Both sides start from the same inputs.  The numbers compared, each against
the limit its cell's file (``workloads/<cell>.json``) gives:

``loss``
    each client's summed step losses of each compared round, the gap
    relative to the reference's, the worst round of each client;
``grad``
    Adam's first moment after round 1 (the gradients as the optimizer got
    them), the worst leaf of each client;
``change``
    the block's change after the last compared round, the worst leaf of
    each client; and the consensus ``z``'s worst leaf;
``stats``
    the change of every BatchNorm running statistic after the last
    compared round, the worst statistic of each client;
``exchange`` (cells followed step by step)
    what each exchange left, against the reference's exchange from the
    program's own state before it, the worst leaf and round.

A leaf's gap is that between the program's norm and the reference's,
over the larger of the reference's norm of that leaf and of the median
leaf (of that client).  Of the per-client worsts the median over the
clients is compared (``z``'s and the exchange's worst gap besides): on a
few seeds in ten one client's trajectory parts from the reference's by a
rounding event that float32 carries (an Adam step of a gradient within
rounding of zero), while a fault or a lower precision moves every client.
The worst client is kept in ``detail`` beside it.  A leaf whose reference
gradient is under a thousandth of the median leaf's (nought to rounding,
which Adam moves by round-off alone) is left out of ``change``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

#: a leaf is left out of ``change`` when its reference gradient norm is
#: under this share of the median leaf's
GRAD_FLOOR = 1e-3


def leaf_norms(stack: torch.Tensor, sizes: Sequence[int]) -> np.ndarray:
    """[rows, leaves] norms of each leaf's segment of each row of
    ``stack`` [rows, N]."""
    parts = torch.split(stack.to(torch.float64), list(sizes), dim=1)
    return torch.stack([p.norm(dim=1) for p in parts], dim=1).numpy()


def gaps(prog: np.ndarray, ref: np.ndarray,
         keep: np.ndarray = None) -> np.ndarray:
    """[rows, leaves] of |prog - ref| / max(ref, median of the row's ref),
    0 where ``keep`` is False."""
    med = np.median(ref, axis=1, keepdims=True)
    gap = np.abs(prog - ref) / np.maximum(np.maximum(ref, med), 1e-30)
    if keep is not None:
        gap = np.where(np.broadcast_to(keep, gap.shape), gap, 0.0)
    return gap


def worst(gap: np.ndarray, name: str, detail: Optional[dict],
          labels: Sequence[str]) -> float:
    """The largest of ``gap``; ``detail[name]`` says where (row, leaf)."""
    if detail is not None and gap.size:
        row, col = np.unravel_index(np.nanargmax(gap) if np.isfinite(gap).any()
                                    else 0, gap.shape)
        detail[name] = {"row": int(row), "leaf": labels[col],
                        "worst": float(gap.max())}
    return float(gap.max()) if gap.size else 0.0


def numbers(prog: dict, ref: dict, sizes: Sequence[int], x_init: torch.Tensor,
            stats_init: Dict[str, torch.Tensor],
            detail: Optional[dict] = None) -> Dict[str, float]:
    """The compared numbers of a program run ``prog`` against the
    reference ``ref``: each holds ``losses`` [[client loss] a round] and
    ``states`` {1: {"mu"}, last: {"x", "z", "stats"}}.  ``detail``, when
    given, gets each number's per-client worsts and where the worst lies."""
    last = max(ref["states"])
    leaves = [str(n) for n in ref.get("names", range(len(sizes)))]
    pl = np.asarray(prog["losses"], np.float64)
    rl = np.asarray(ref["losses"], np.float64)
    out = {"loss": steady((np.abs(pl - rl) / np.maximum(np.abs(rl), 1e-30)).T,
                          "loss", detail, [f"round {r + 1}"
                                           for r in range(rl.shape[0])])}
    g_ref = leaf_norms(ref["states"][1]["mu"], sizes)
    out["grad"] = steady(gaps(leaf_norms(prog["states"][1]["mu"], sizes),
                              g_ref), "grad", detail, leaves)
    moving = g_ref >= GRAD_FLOOR * np.median(g_ref, axis=1, keepdims=True)
    ps, rs = prog["states"][last], ref["states"][last]
    x0 = x_init.to(torch.float64)
    out["change"] = steady(
        gaps(leaf_norms(ps["x"].to(torch.float64) - x0, sizes),
             leaf_norms(rs["x"].to(torch.float64) - x0, sizes), moving),
        "change", detail, leaves)
    if "z" in ps:
        # z starts every block at zero
        out["change"] = max(out["change"], worst(
            gaps(leaf_norms(ps["z"][None], sizes),
                 leaf_norms(rs["z"][None], sizes), moving.any(axis=0)),
            "change_z", detail, leaves))
    names = sorted(rs["stats"])
    change = lambda st: np.stack(
        [(st[n].to(torch.float64) - stats_init[n].to(torch.float64))
         .norm(dim=1).numpy() for n in names], axis=1)
    out["stats"] = steady(gaps(change(ps["stats"]), change(rs["stats"])),
                          "stats", detail, names)
    return out


def steady(gap: np.ndarray, name: str, detail: Optional[dict],
           labels: Sequence[str]) -> float:
    """The median over clients (rows) of each client's worst entry."""
    per_client = gap.max(axis=1)
    if detail is not None:
        worst(gap, name, detail, labels)
        detail[name]["clients"] = [float(v) for v in per_client]
    return float(np.median(per_client))


def exchange(prog: List[dict], ref: List[dict], sizes: Sequence[int],
             detail: Optional[dict] = None) -> float:
    """The worst gap, over the rounds and the leaves, of what each
    exchange left (the consensus, the block stack, the duals, the
    residuals) in the program against the reference's exchange from the
    same state."""
    rows = []
    for p, r in zip(prog, ref):
        for key in ("z", "x", "y", "resid"):
            if r.get(key) is None:
                continue
            a, b = p[key], r[key]
            a, b = (a[None], b[None]) if a.dim() == 1 else (a, b)
            rows.append(gaps(leaf_norms(a, sizes), leaf_norms(b, sizes)))
    if len(prog) != len(ref) or not rows:
        return float("nan")
    return worst(np.concatenate(rows), "exchange", detail,
                 [str(i) for i in range(len(sizes))])


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every compared number is finite and within its limit."""
    return all(name in nums and np.isfinite(nums[name])
               and nums[name] <= limit for name, limit in limits.items())


def lines(nums: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    """``<name> <number> limit <limit>`` of each compared number."""
    return [f"{n} {nums.get(n, float('nan'))!r} limit {limits[n]!r}"
            for n in limits]
