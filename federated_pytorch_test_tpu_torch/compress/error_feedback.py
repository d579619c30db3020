"""Error-feedback wrapper: dropped mass re-enters the next round.

Port of ``federated_pytorch_test_tpu/compress/error_feedback.py``: compress
``u = vec + residual`` instead of ``vec`` and carry
``residual' = u - decode(encode(u))`` in the per-client state, next to the
inner compressor's stream state.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from federated_pytorch_test_tpu_torch.compress.base import Compressor


class ErrorFeedback(Compressor):
    def __init__(self, inner: Compressor):
        if inner.name == "none":
            raise ValueError("error feedback around the identity "
                             "compressor is a no-op; refuse loudly")
        self.inner = inner
        self.name = inner.name + "+ef"
        self.sparse = inner.sparse

    def init_state(self, n: int, seeds: np.ndarray, device):
        return {"inner": self.inner.init_state(n, seeds, device),
                "resid": torch.zeros((len(seeds), n), dtype=torch.float32,
                                     device=device)}

    def encode(self, vecs: torch.Tensor, state) -> Tuple[Any, Any]:
        u = vecs + state["resid"]
        payload, inner2 = self.inner.encode(u, state["inner"])
        resid = u - self.inner.decode(payload, u.shape[1])
        return payload, {"inner": inner2, "resid": resid}

    def decode(self, payload, n: int) -> torch.Tensor:
        return self.inner.decode(payload, n)

    def transport_params(self):
        return self.inner.transport_params()

    def reset_state(self, state):
        """Reset the residual (it was computed from a rejected delta), keep
        the inner stream state."""
        return {"inner": self.inner.reset_state(state["inner"]),
                "resid": torch.zeros_like(state["resid"])}

    def bytes_on_wire(self, n: int) -> int:
        return self.inner.bytes_on_wire(n)
