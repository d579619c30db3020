"""Observability of the port's runs: one schema-validated JSONL stream a
run (run header, a ``round`` and a ``client`` record a communication
round, phase spans, watchdog alerts, control records, a summary), and the
readers of such streams.

Port of ``federated_pytorch_test_tpu/obs/`` without the device-cost ledger
(``costs``, which observes jit compiles).  The readers are copies of the
JAX package's: either package's reader reads either package's stream and
prints the same thing.  They are host tools: they read JSON, never the
card.

- :mod:`.schema`   -- versioned records and ``validate_record``.
- :mod:`.sinks`    -- JSONL (with retry and degradation), CSV, stdout and
  in-memory emitters.
- :mod:`.metrics`  -- host-side counters, gauges and timers.
- :mod:`.recorder` -- the per-run emitter the engines thread through.
- :mod:`.health`   -- the streaming watchdog (``--health-action``).
- :mod:`.clients`  -- the ``client`` record's fields, and the client
  ledger, anomaly ranking and cohort rollup
  (``python -m federated_pytorch_test_tpu_torch.obs.clients``).
- :mod:`.report`   -- the run summary and the chained selftests
  (``python -m federated_pytorch_test_tpu_torch.obs.report``).
- :mod:`.trace`    -- span timeline to Chrome trace-event JSON
  (``python -m federated_pytorch_test_tpu_torch.obs.trace``).
- :mod:`.profile`  -- the cost profile of ``compile`` and round records
  (``python -m federated_pytorch_test_tpu_torch.obs.profile``).
- :mod:`.compare`  -- the cross-run regression gate
  (``python -m federated_pytorch_test_tpu_torch.obs.compare``).
"""

from federated_pytorch_test_tpu_torch.obs.clients import (  # noqa: F401
    ClientLedger,
    client_round_fields,
    ledger_from_records,
    summarize_clients,
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
