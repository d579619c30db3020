"""Faults planted in the program under test, underneath the harness, for
the checks' own tests and the calibration of the limits.  Each takes a
:class:`portbench.drive.Cell` and breaks its trainer in place.

* ``unchanged``: a round that returns its state unchanged (no local
  step, no exchange);
* ``half_batch``: every minibatch loses its second half, the loss the
  mean over the rest;
* ``no_exchange``: the packed collective's hops between the mesh's
  devices deliver nothing, so each device's segment holds its own
  clients' sum alone (cells whose exchange spans more than one device).

A training cell has no token or answer that a fault could alter where it
is produced: its outputs are states, which ``unchanged`` covers.
"""

from __future__ import annotations

import torch


def unchanged(cell) -> None:
    t = cell.trainer

    def train_epoch(state, ci, y, z, rho, xb, *a, **kw):
        return state, torch.zeros(t.n_rows, device=t.device)

    def comm_round(state, ci, z, y, rho, x0, yhat0, *a, **kw):
        return state, z, y, rho, x0, yhat0, {}, None

    t.train_epoch, t.comm_round = train_epoch, comm_round


def half_batch(cell) -> None:
    t = cell.trainer
    loss = t.model_loss

    def model_loss(p, bs, xb, yb, wb, noise=None):
        h = xb.shape[0] // 2
        return loss(p, bs, xb[:h], yb[:h], wb[:h], noise)

    t.model_loss = model_loss


def no_exchange(cell) -> None:
    mesh = cell.trainer.mesh
    if mesh.size < 2:
        raise ValueError("no_exchange needs a mesh of two devices or more")

    def ppermute(parts, perm):
        out = [None] * mesh.size
        for src, dst in perm:
            q, scale = parts[src]
            out[dst] = (torch.zeros_like(q), scale)
        return out

    mesh.ppermute = ppermute


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "no_exchange": no_exchange}


def applicable(traffic: dict):
    """The faults a cell of ``traffic`` can have."""
    names = ["unchanged", "half_batch"]
    if traffic.get("fused_collective") and traffic.get("num_devices", 1) > 1:
        names.append("no_exchange")
    return names
