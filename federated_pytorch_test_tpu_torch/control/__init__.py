"""Closed-loop federation control plane (default OFF).

Port of ``federated_pytorch_test_tpu/control/``, the elastic ``reshape``
rung over the one card's logical client mesh included.

Three cooperating parts (README "Control plane"):

- :mod:`.policy` — pure deterministic rules mapping the recorded
  telemetry stream (round records + health alerts) to typed
  interventions, emitted as ``control`` records (obs schema v8);
- :mod:`.supervisor` — bounded-retry restart with seeded exponential
  backoff and a cumulative degradation ladder;
- :mod:`.replay` — ``python -m federated_pytorch_test_tpu_torch.control.replay``
  re-derives decisions from a recorded stream and diffs them against
  the recorded records (the determinism contract).

The train/ engines import this package lazily and only when
``--control`` is not ``off`` / ``--max-restarts`` is nonzero, so the
default path never touches it.
"""

from federated_pytorch_test_tpu_torch.control.policy import (  # noqa: F401
    COMPRESS_LADDER,
    CONTROL_MODES,
    CONTROL_POLICIES,
    Controller,
    ControlPolicy,
    ControlRestart,
    Decision,
    controller_from_config,
)
from federated_pytorch_test_tpu_torch.control.supervisor import (  # noqa: F401
    DEGRADATION_LADDER,
    RestartBudgetExhausted,
    ladder_overrides,
    restart_backoff_seconds,
    supervise,
    supervise_classifier,
)
