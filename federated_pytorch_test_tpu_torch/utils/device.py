"""Device selection: the port runs on the card unless told otherwise."""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """``torch.device`` for ``name`` ("cuda", "cuda:N" or "cpu").

    A CUDA device that is not available raises: the port never carries on
    on the CPU unless the caller asked for the CPU.
    """
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={name!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device={name!r}: only 'cuda' and 'cpu' are supported")
    return dev
