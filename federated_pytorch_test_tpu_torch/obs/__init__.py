"""Observability of the port's runs: one schema-validated JSONL stream a
run (run header, a ``round`` and a ``client`` record a communication
round, phase spans, watchdog alerts, control records, a summary).

Port of ``federated_pytorch_test_tpu/obs/`` without the readers
(``report``, ``compare``, ``profile``, ``trace``) and the device-cost
ledger (``costs``); the JAX package's readers read the port's streams.

- :mod:`.schema`   -- versioned records and ``validate_record``.
- :mod:`.sinks`    -- JSONL (with retry and degradation), CSV, stdout and
  in-memory emitters.
- :mod:`.metrics`  -- host-side counters, gauges and timers.
- :mod:`.recorder` -- the per-run emitter the engines thread through.
- :mod:`.clients`  -- the ``client`` record's fields.
- :mod:`.health`   -- the streaming watchdog (``--health-action``).
"""

from federated_pytorch_test_tpu_torch.obs.clients import (  # noqa: F401
    client_round_fields,
)
from federated_pytorch_test_tpu_torch.obs.health import (  # noqa: F401
    HEALTH_ACTIONS,
    HealthMonitor,
    RunHealthAbort,
    monitor_from_config,
)
from federated_pytorch_test_tpu_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Metrics,
    Timer,
)
from federated_pytorch_test_tpu_torch.obs.recorder import (  # noqa: F401
    RunRecorder,
    device_memory_stats,
    git_rev,
    make_recorder,
)
from federated_pytorch_test_tpu_torch.obs.schema import (  # noqa: F401
    SCHEMA_VERSION,
    SchemaError,
    json_safe,
    validate_record,
)
from federated_pytorch_test_tpu_torch.obs.sinks import (  # noqa: F401
    CsvSink,
    JsonlSink,
    MemorySink,
    Sink,
    StdoutSink,
    make_sinks,
)
