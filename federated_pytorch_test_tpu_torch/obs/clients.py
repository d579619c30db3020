"""The ``client`` record (schema v10/v11): one a communication round, the
round record's counters un-aggregated into length-K lists.

Port of :func:`client_round_fields` of
``federated_pytorch_test_tpu/obs/clients.py``; the ledger, the anomaly
ranking and the CLI that read these records are not ported (the JAX
package's ``obs.clients`` reads the port's streams as they are).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


def client_round_fields(round_index: int, clients: int, *,
                        update_norm=None, dist_z=None, loss=None,
                        weight=None, active=None, guard_ok=None,
                        quarantine=None, dropped=None, straggled=None,
                        corrupted=None, staleness=None, admitted=None,
                        members=None, registry_ids=None,
                        payload_bytes: Optional[int] = None
                        ) -> Dict[str, Any]:
    """Assemble a schema-v11 ``client`` record body from host arrays.

    Every array argument is optional (advisory fields — absent means
    "that subsystem was off") and is coerced to a plain length-K Python
    list so the record validates and JSON-round-trips (NaN entries
    survive: the JSONL sink writes ``NaN``, ``json.loads`` reads it
    back).  ``staleness`` uses -1 for "no arrival this round".
    ``registry_ids`` (population mode) maps slot k to the registry id
    of the virtual client that occupied it this round.
    """
    fields: Dict[str, Any] = {"round_index": int(round_index),
                              "clients": int(clients)}

    def put(name, arr, cast):
        if arr is None:
            return
        a = np.asarray(arr).reshape(-1)
        if a.shape[0] != clients:
            raise ValueError(f"{name}: expected length {clients}, "
                             f"got {a.shape[0]}")
        fields[name] = [cast(v) for v in a.tolist()]

    put("update_norm", update_norm, float)
    put("dist_z", dist_z, float)
    put("loss_client", loss, float)
    put("weight", weight, float)
    put("active", active, float)
    put("guard_ok", guard_ok, float)
    put("quarantine", quarantine, int)
    put("dropped", dropped, float)
    put("straggled", straggled, float)
    put("corrupted", corrupted, float)
    put("staleness", staleness, int)
    put("admitted", admitted, float)
    put("members", members, float)
    put("registry_ids", registry_ids, int)
    if payload_bytes is not None:
        fields["payload_bytes"] = int(payload_bytes)
    return fields
