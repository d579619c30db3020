"""Deterministic fault injection for federated rounds.

Port of ``federated_pytorch_test_tpu/train/faults.py``.  The spec grammar,
its errors and every seeded draw (participation-free fault indicators,
tag 47; transit delays, tags 53 and 61; churn, tag 67; preemption, tag 71)
are the JAX package's numpy code, copied so that a spec replays bit for
bit in either package.  :func:`apply_corruption` is the torch version of
the JAX ``jnp.where`` selects.

Spec grammar (``--fault-spec``)::

    none
    drop=P,straggle=P,corrupt=P,mode=M,scale=X,seed=N,clients=i+j+k,
    delay=P,delay_max=N,join=P,leave=P,preempt=P

``P`` are independent per-client per-round probabilities; ``mode`` is one
of ``nan | inf | signflip | scale | innerprod | collude`` (default
``scale``); ``scale`` multiplies for ``mode=scale`` (default 100) and sets
the magnitude of the collective modes; ``clients`` restricts drop,
straggle and corrupt to the listed client indices.  Precedence per client
and round: drop beats straggle beats corrupt.  ``delay`` puts a
dispatched update in transit for a geometric number of rounds (async
rounds only); ``join``/``leave`` move the churn membership ledger;
``preempt`` raises :class:`~federated_pytorch_test_tpu_torch.parallel.mesh.CollectiveTimeoutError`
at a round once a mid-run checkpoint exists.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from federated_pytorch_test_tpu_torch.parallel.mesh import ClientMesh

CORRUPT_MODES = ("nan", "inf", "signflip", "scale", "innerprod", "collude")

#: canonical fault-tag names, in precedence order (drop beats straggle
#: beats corrupt) — these ARE the per-client list-field names the
#: engines write into schema-v10 `client` records (obs/clients.py), so
#: a ledger consumer can map a glyph/field back to the injection family
#: without guessing.  The delay family surfaces as `staleness`/
#: `admitted` and churn as `members` in the same records.
FAULT_TAGS = ("dropped", "straggled", "corrupted")


class RoundFaults(NamedTuple):
    """Per-client 0/1 fault indicators for one communication round."""

    drop: np.ndarray        # [K] f32 — client lost for the round
    straggle: np.ndarray    # [K] f32 — local epochs withheld, stale update
    corrupt: np.ndarray     # [K] f32 — update delta corrupted on the wire


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Parsed ``--fault-spec`` (see module docstring for the grammar)."""

    drop: float = 0.0
    straggle: float = 0.0
    corrupt: float = 0.0
    mode: str = "scale"
    scale: float = 100.0
    seed: int = 0
    clients: Optional[Tuple[int, ...]] = None   # None = every client eligible
    delay: float = 0.0          # per-round in-transit continuation probability
    delay_max: int = 8          # staleness cap on any single delivery
    join: float = 0.0           # per-round rejoin probability (churn)
    leave: float = 0.0          # per-round departure probability (churn)
    preempt: float = 0.0        # per-round simulated slice-preemption prob.

    @property
    def enabled(self) -> bool:
        return (self.drop > 0 or self.straggle > 0 or self.corrupt > 0
                or self.delay > 0 or self.churn_enabled or self.preempt > 0)

    @property
    def churn_enabled(self) -> bool:
        """Does this spec ever change the membership ledger?"""
        return self.join > 0 or self.leave > 0

    @property
    def masking(self) -> bool:
        """Does this spec ever change the round activity masks?"""
        return self.drop > 0 or self.straggle > 0

    @property
    def delaying(self) -> bool:
        """Does this spec ever put an update in transit (async mode only)?"""
        return self.delay > 0

    @classmethod
    def parse(cls, spec: Optional[str]) -> "FaultSpec":
        """``"none"``/empty/None -> the disabled spec; else key=value CSV."""
        if spec is None or spec.strip() in ("", "none"):
            return cls()
        kw: dict = {}
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(
                    f"fault-spec item {item!r} is not key=value "
                    "(grammar: drop=P,straggle=P,corrupt=P,mode=M,"
                    "scale=X,seed=N,clients=i+j)")
            key, val = (s.strip() for s in item.split("=", 1))
            if key in ("drop", "straggle", "corrupt"):
                p = float(val)
                if not 0.0 <= p <= 1.0:
                    raise ValueError(f"fault-spec {key}={p} outside [0, 1]")
                kw[key] = p
            elif key == "delay":
                p = float(val)
                if not 0.0 <= p < 1.0:
                    raise ValueError(
                        f"fault-spec delay={p} outside [0, 1) (a continuation "
                        "probability of 1 would never deliver)")
                kw[key] = p
            elif key in ("join", "leave", "preempt"):
                p = float(val)
                if not 0.0 <= p <= 1.0:
                    raise ValueError(f"fault-spec {key}={p} outside [0, 1]")
                kw[key] = p
            elif key == "delay_max":
                n = int(val)
                if n < 0:
                    raise ValueError(f"fault-spec delay_max={n} is negative")
                kw[key] = n
            elif key == "mode":
                if val not in CORRUPT_MODES:
                    raise ValueError(f"fault-spec mode={val!r}; expected one "
                                     f"of {CORRUPT_MODES}")
                kw[key] = val
            elif key == "scale":
                kw[key] = float(val)
            elif key == "seed":
                kw[key] = int(val)
            elif key == "clients":
                idx = tuple(int(s) for s in val.split("+") if s != "")
                if not idx or any(i < 0 for i in idx):
                    raise ValueError(
                        f"fault-spec clients={val!r}: need non-negative "
                        "indices joined by '+'")
                kw[key] = idx
            else:
                raise ValueError(f"unknown fault-spec key {key!r}")
        out = cls(**kw)
        if not out.enabled:
            raise ValueError(
                f"fault-spec {spec!r} names no fault probability "
                "(set drop/straggle/corrupt/delay/join/leave/preempt, "
                "or pass 'none')")
        return out

    def round_faults(self, K: int, nloop: int, ci: int, nadmm: int
                     ) -> RoundFaults:
        """The [K] fault indicators for round ``(nloop, ci, nadmm)``.

        Stateless in the round coordinates (same recipe as the engine's
        participation masks) so runs and resumed runs draw the identical
        schedule; the ``47`` tag keeps the stream disjoint from the
        participation (11) and compressor (23) streams.
        """
        if self.clients is not None and any(i >= K for i in self.clients):
            raise ValueError(
                f"fault-spec clients={self.clients} out of range for K={K}")
        rng = np.random.default_rng([self.seed, 47, nloop, ci, nadmm])
        u = rng.random((3, K))
        eligible = np.zeros(K, np.float32)
        if self.clients is None:
            eligible[:] = 1.0
        else:
            eligible[list(self.clients)] = 1.0
        drop = (u[0] < self.drop).astype(np.float32) * eligible
        straggle = ((u[1] < self.straggle).astype(np.float32)
                    * eligible * (1.0 - drop))
        corrupt = ((u[2] < self.corrupt).astype(np.float32)
                   * eligible * (1.0 - drop) * (1.0 - straggle))
        return RoundFaults(drop, straggle, corrupt)

    def round_delays(self, K: int, nloop: int, ci: int, nadmm: int
                     ) -> np.ndarray:
        """[K] int64 in-transit round counts for updates DISPATCHED at
        round ``(nloop, ci, nadmm)``; 0 means same-round delivery.

        Two seeded streams compose the draw: a per-client heterogeneity
        factor in [0.5, 1.5] fixed for the whole run (tag ``53`` — some
        clients sit on persistently slower links), and a per-round
        geometric draw (tag ``61``) stateless in the round coordinates,
        so fresh runs and mid-run resumes replay the identical arrival
        schedule.  ``P(delay >= d) = p_k^d`` with ``p_k = clip(delay *
        het_k, 0, 0.99)``, capped at ``delay_max``.  NOT gated by
        ``clients=`` (see module docstring).
        """
        if self.delay <= 0.0 or self.delay_max <= 0:
            return np.zeros(K, np.int64)
        het = np.random.default_rng([self.seed, 53]).uniform(0.5, 1.5, K)
        p = np.clip(self.delay * het, 0.0, 0.99)
        u = np.random.default_rng(
            [self.seed, 61, nloop, ci, nadmm]).random(K)
        with np.errstate(divide="ignore"):
            d = np.floor(np.log(np.maximum(u, 1e-300))
                         / np.log(np.maximum(p, 1e-300)))
        d = np.where(p > 0.0, d, 0.0)
        return np.clip(d, 0, self.delay_max).astype(np.int64)

    def round_churn(self, members: np.ndarray, nloop: int, ci: int,
                    nadmm: int) -> np.ndarray:
        """Advance the [K] bool membership ledger by one round.

        A pure function of ``(seed, round coordinates, members)`` — the
        ledger itself carries the history, so replaying the rounds from
        any checkpointed ledger reproduces the identical trajectory (tag
        ``67`` keeps the stream disjoint from every other family).  The
        lowest-indexed live member is immune to eviction: the federation
        never goes empty.
        """
        if not self.churn_enabled:
            return members
        members = np.asarray(members, bool)
        K = members.shape[0]
        u = np.random.default_rng(
            [self.seed, 67, nloop, ci, nadmm]).random((2, K))
        joined = ~members & (u[0] < self.join)
        left = members & (u[1] < self.leave)
        anchor = int(np.argmax(members)) if members.any() else 0
        left[anchor] = False
        return (members | joined) & ~left

    def round_preempt(self, nloop: int, ci: int, nadmm: int) -> bool:
        """Does round ``(nloop, ci, nadmm)`` simulate a slice preemption?

        Single seeded draw (tag ``71``), stateless in the round
        coordinates like every other family.  The ENGINE makes this
        one-shot (disarmed on resumed segments); the draw itself is
        deterministic so the chaos tests can predict the failing round.
        """
        if self.preempt <= 0.0:
            return False
        u = np.random.default_rng(
            [self.seed, 71, nloop, ci, nadmm]).random()
        return bool(u < self.preempt)


def apply_corruption(delta: torch.Tensor, corrupt: torch.Tensor, mode: str,
                     scale: float, w: Optional[torch.Tensor] = None,
                     mesh: Optional[ClientMesh] = None) -> torch.Tensor:
    """Corrupt the client-stacked update deltas ``[K, N]``.

    ``corrupt`` is the per-client 0/1 indicator ``[K]``.  Selects only,
    never mask arithmetic, so a NaN or inf row cannot leak into the other
    clients' rows.  The collective modes (``innerprod``/``collude``) need
    cross-client means: ``w`` is the per-client activity weight (None:
    every client active) and ``mesh`` the client mesh whose shards' local
    sums are ``psum``-ed in order (None: one sum over the whole stack).
    The elementwise modes ignore both.
    """
    c = corrupt.reshape((-1,) + (1,) * (delta.dim() - 1)) > 0
    if mode == "nan":
        return torch.where(c, torch.full_like(delta, float("nan")), delta)
    if mode == "inf":
        return torch.where(c, torch.full_like(delta, float("inf")), delta)
    if mode == "signflip":
        return torch.where(c, -delta, delta)
    if mode == "scale":
        return torch.where(c, scale * delta, delta)
    if mode in ("innerprod", "collude"):
        act = torch.ones_like(corrupt) if w is None else w
        if mode == "innerprod":
            # mean of the honest active deltas; corrupted rows flip against it
            sel = act * (1.0 - corrupt)
            sgn = -scale
        else:
            # mean of the colluding subset: every colluder ships one copy
            sel = act * corrupt
            sgn = scale
        selr = sel.reshape(c.shape)
        part = torch.where(selr > 0, selr * delta, torch.zeros_like(delta))
        if mesh is None:
            num, den = part.sum(dim=0), sel.sum()
        else:
            num = mesh.psum([p.sum(dim=0) for p in mesh.shards(part)])
            den = mesh.psum([s.sum() for s in mesh.shards(sel)])
        g = num / torch.where(den > 0, den, torch.ones_like(den))
        return torch.where(c, sgn * g[None, ...], delta)
    raise ValueError(f"unknown corruption mode {mode!r}")
