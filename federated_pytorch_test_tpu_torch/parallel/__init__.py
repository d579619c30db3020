"""The client mesh and the federated collectives over it (one process, or
the ranks of a ``torch.distributed`` process group)."""

from federated_pytorch_test_tpu_torch.parallel.mesh import (  # noqa: F401
    ClientMesh,
    CollectiveTimeoutError,
    RankMesh,
    barrier_timeout,
    bounded_wait,
    client_mesh,
    collective_timeout_count,
    configure_barrier_timeout,
    fetch,
    heartbeat,
    initialize_multihost,
    last_heartbeat_age,
    local_client_rows,
    process_count,
    process_index,
    stage_client_rows,
    stage_global,
    stage_tree_global,
    sync_global,
    usable_device_count,
)
from federated_pytorch_test_tpu_torch.parallel.comm import (  # noqa: F401
    all_clients_dot,
    compressed_federated_mean,
    federated_mean,
    federated_sum,
    per_client_norms,
    robust_federated_mean_chunked,
    robust_gather_bytes,
    sharded_federated_mean,
)
