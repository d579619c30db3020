"""Serving plane: batched online inference over the consensus model.

Port of ``federated_pytorch_test_tpu/serve/``.  The training loop
(``train/rounds.py``) produces a consensus every round; this package
turns it into something that answers requests:

- ``infer``      pad-to-bucket batched predict per engine head (classifier
                 logits, VAE reconstruction score, CPC embedding) at a
                 bounded set of shapes.
- ``batcher``    the deterministic request micro-batcher and the seeded
                 synthetic-traffic grammar (``ServeSchedule``, draw tag
                 83), whose per-round record is a pure function of (seed,
                 round index) that ``control/replay.py`` re-derives.
- ``swap``       the double-buffered round-boundary hot-swap: a request
                 in flight is answered by exactly the old or the new
                 weights, never a torn mix.
- ``evalstream`` served traffic doubles as an eval stream whose live
                 accuracy feeds ``obs/health.py``'s ``serve_drift`` rule
                 and, in act mode, the control plane.

Serving is off by default (``cfg.serve_spec == "none"``), and serving on
trains the same trajectory bit for bit.
"""

from federated_pytorch_test_tpu_torch.serve.batcher import (  # noqa: F401
    SERVE_FIELDS,
    SERVE_TAG,
    MicroBatcher,
    ServeSchedule,
)
from federated_pytorch_test_tpu_torch.serve.evalstream import (  # noqa: F401
    EvalStream,
)
from federated_pytorch_test_tpu_torch.serve.infer import (  # noqa: F401
    HEADS,
    BatchedPredictor,
    bucket_for,
    consensus_weights,
    pad_to_bucket,
)
from federated_pytorch_test_tpu_torch.serve.swap import (  # noqa: F401
    DoubleBuffer,
    version_for,
)
