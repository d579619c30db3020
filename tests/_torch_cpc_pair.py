"""Run the JAX CPC trainer and the port's on the same start.

Both sides read the same synthetic LOFAR draws (``CPCDataSource`` keyed on
(seed, round, client)) at the toy geometry of the JAX package's own CPC
fault tests (Lc=8, Rc=4, L-BFGS history 3 and max_iter 1, Niter 1, batch
2), the port starting from the JAX trainer's ``state0`` carried across
with ``bridge.py``.  :func:`run_both` returns both histories and both
final states in the JAX layout.
"""

import jax
import numpy as np

from federated_pytorch_test_tpu.data.lofar import CPCDataSource as JSource
from federated_pytorch_test_tpu.train.config import FederatedConfig as JConfig
from federated_pytorch_test_tpu.train.cpc_engine import CPCTrainer as JTrainer
from federated_pytorch_test_tpu_torch import bridge
from federated_pytorch_test_tpu_torch.data.lofar import CPCDataSource as TSource
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig as TConfig
from federated_pytorch_test_tpu_torch.train.cpc_engine import CPCTrainer as TTrainer

GEOM = dict(latent_dim=8, reduced_dim=4, lbfgs_history=3, lbfgs_max_iter=1,
            Niter=1)
FILES2, SAPS2 = ["a.h5", "b.h5"], ["0", "1"]
FILES4, SAPS4 = ["a.h5", "b.h5", "c.h5", "d.h5"], ["0", "1", "0", "1"]
SILENT = lambda m: None

#: the round fields that are counts: equal on both sides, exactly
COUNTS = ("nloop", "model", "block", "nadmm", "N", "host_dispatches",
          "bytes_on_wire",
          "n_active", "guard_trips", "n_ok", "quarantined", "fault_dropped",
          "fault_straggled", "fault_corrupted", "async_arrived",
          "admission_rejected", "buffer_depth", "staleness_hist",
          "members_active", "joined", "left")


def jax_trainer(files, saps, **cfg):
    return JTrainer(JSource(files, saps, batch_size=2, seed=7),
                    cfg=JConfig(check_results=False, **cfg), **GEOM)


def port_trainer(files, saps, **cfg):
    return TTrainer(TSource(files, saps, batch_size=2, seed=7),
                    cfg=TConfig(device="cpu", **cfg), **GEOM)


def run_both(files, saps, Nadmm: int, jrun=None, **cfg) -> dict:
    """Both trainers on the robustness knobs ``cfg``, one rotation of
    ``Nadmm`` rounds a block; ``jrun``: extra keywords of the JAX run
    (its obs plumbing; the port reads the same knobs from its config, and
    writes its stream to ``<obs_dir>_port``)."""
    jt = jax_trainer(files, saps, **cfg)
    jstate, jhist = jt.run(Nloop=1, Nadmm=Nadmm, log=SILENT, prefetch=False,
                           **(jrun or {}))
    state0 = bridge.cpc_state_from_jax(jax.tree.map(np.asarray, jt.state0))
    tcfg = dict(cfg)
    for k in ("obs_dir", "obs_sinks", "health_action"):
        if jrun and k in jrun:
            tcfg[k] = jrun[k] + ("_port" if k == "obs_dir" else "")
    tt = port_trainer(files, saps, **tcfg)
    tstate, thist = tt.run(Nloop=1, Nadmm=Nadmm, state=state0, log=SILENT,
                           prefetch=False)
    return dict(jt=jt, tt=tt, jhist=jhist, thist=thist, state0=state0,
                jstate=jax.tree.map(np.asarray, jstate._asdict()),
                tstate=bridge.cpc_state_to_jax(tstate))


def counts(hist) -> list:
    return [{k: r[k] for k in COUNTS if k in r} for r in hist]
