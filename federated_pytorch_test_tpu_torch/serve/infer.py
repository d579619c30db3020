"""Batched predict over the consensus state at bounded shapes.

Port of ``federated_pytorch_test_tpu/serve/infer.py``.  Training holds
per-client stacked state ``[K, ...]``; :func:`consensus_weights` collapses
it to the single served model (the plain mean over the clients, the
server average the round converges to).  :class:`BatchedPredictor` only
ever runs its head at the configured pad-bucket shapes, so the set of
batch shapes the device sees is bounded by ``len(buckets)`` whatever the
traffic draw produces (the JAX predictor's "jit once").

Heads are post-processors over an injected forward callable (classifier:
logits; VAE: per-sample reconstruction score; CPC: flattened embedding),
so they unit-test with toy callables and attach to any engine's model
without this module importing engine code.  Serving is a read: the
forward runs under ``torch.inference_mode()`` on weights the trainer
keeps using, and the hot-swap buffer may hand the same weights to many
batches.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from federated_pytorch_test_tpu_torch.utils.tree import map_leaves


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; the largest bucket when none fits (the
    micro-batcher splits oversize groups before padding)."""
    for b in buckets:
        if n <= b:
            return int(b)
    return int(buckets[-1])


def pad_to_bucket(x: np.ndarray, bucket: int) -> np.ndarray:
    """Pad ``x`` along axis 0 to ``bucket`` rows by repeating row 0 (a
    real sample, so the padded batch is valid model input); the pad rows
    are sliced off the output, never scored."""
    x = np.asarray(x)
    n = x.shape[0]
    if n == bucket:
        return x
    if n > bucket:
        raise ValueError(f"batch of {n} does not fit bucket {bucket}")
    return np.concatenate([x, np.repeat(x[:1], bucket - n, axis=0)], axis=0)


def consensus_weights(stacked_tree: Any) -> Any:
    """Mean over the leading per-client dimension of every leaf, in
    float32 and cast back to the leaf's dtype (integer leaves survive),
    into new tensors: the served consensus z."""
    def mean0(a):
        return a.to(torch.float32).mean(dim=0).to(a.dtype)

    return map_leaves(mean0, stacked_tree)


# ----------------------------------------------------------------------
# engine heads: forward(weights, x) -> engine-shaped per-request output
# ----------------------------------------------------------------------
def classifier_head(forward: Callable[[Any, Any], Any]):
    """Logits passthrough ([n, n_classes])."""
    def raw_fn(weights, x):
        return forward(weights, x)
    return raw_fn


def vae_head(forward: Callable[[Any, Any], Any]):
    """Per-sample reconstruction score ``-mean((recon - x)^2)`` per row,
    higher is better; the model may return the reconstruction alone or a
    (recon, ...) tuple."""
    def raw_fn(weights, x):
        out = forward(weights, x)
        recon = out[0] if isinstance(out, (tuple, list)) else out
        n = x.shape[0]
        err = (recon.reshape(n, -1) - x.reshape(n, -1).to(recon.dtype)) ** 2
        return -err.mean(dim=-1)
    return raw_fn


def cpc_head(forward: Callable[[Any, Any], Any]):
    """Flattened embedding ([n, d]); the model may return the embedding
    alone or an (embedding, ...) tuple."""
    def raw_fn(weights, x):
        out = forward(weights, x)
        emb = out[0] if isinstance(out, (tuple, list)) else out
        return emb.reshape(x.shape[0], -1)
    return raw_fn


HEADS = {
    "classifier": classifier_head,
    "vae": vae_head,
    "cpc": cpc_head,
}


class BatchedPredictor:
    """Bucketed shapes, any request-batch size.

    ``raw_fn(weights, x)`` is an engine head over torch tensors;
    ``buckets`` the ascending pad sizes of the ``ServeSchedule``;
    ``stage`` moves the padded numpy batch to the engine's device
    (default: a CPU tensor).  Each call pads to its bucket, dispatches at
    that static shape under ``torch.inference_mode()``, brings the output
    back to numpy (the host sync that makes the batcher's latencies real)
    and slices the pad rows off."""

    def __init__(self, raw_fn: Callable[[Any, Any], Any],
                 buckets: Sequence[int],
                 stage: Optional[Callable[[np.ndarray], Any]] = None):
        self.buckets = tuple(int(b) for b in buckets)
        self.stage = stage or torch.from_numpy
        self._fn = raw_fn
        self.dispatches = 0
        self.shapes_seen: set = set()

    def __call__(self, weights: Any, x: np.ndarray) -> np.ndarray:
        """Answer a request batch of any size <= the largest bucket."""
        x = np.asarray(x)
        n = x.shape[0]
        bucket = bucket_for(n, self.buckets)
        if n > bucket:
            raise ValueError(
                f"request batch of {n} exceeds max bucket {bucket}")
        xp = np.ascontiguousarray(pad_to_bucket(x, bucket))
        self.shapes_seen.add(xp.shape)
        with torch.inference_mode():
            out = self._fn(weights, self.stage(xp))
            host = out.cpu().numpy()
        self.dispatches += 1
        return host[:n]
