"""Run the JAX classifier engine and the port's on the same start.

Both sides get the same synthetic CIFAR-10 shards and the same weights (the
JAX trainer's common init, or a per-client spread of it, carried across
with ``bridge.py``); the JAX side pins ``device_data=False`` (its on-device
permutation draws ``jax.random``) and runs its comm kernels in Pallas
interpret mode.  :func:`run_both` returns both histories and final states
as numpy trees in the JAX layout.
"""

import contextlib

import jax
import numpy as np
import torch

from federated_pytorch_test_tpu.data.cifar10 import FederatedCifar10 as JData
from federated_pytorch_test_tpu.ops.comm_kernels import force_comm_kernels_impl
from federated_pytorch_test_tpu.parallel.mesh import (
    client_sharding,
    stage_tree_global,
)
from federated_pytorch_test_tpu.train import (
    BlockwiseFederatedTrainer as JTrainer,
    FederatedConfig as JConfig,
)
from federated_pytorch_test_tpu_torch import bridge
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10 as TData
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig as TConfig
from federated_pytorch_test_tpu_torch.train.engine import (
    BlockwiseFederatedTrainer as TTrainer,
    ClientState,
)

K = 4
#: 40 images per client in batches of 16: the last batch of every epoch
#: has 8 pad rows
DATA = dict(K=K, batch=16, limit_per_client=40, limit_test=32,
            biased_input=True)
BASE = dict(K=K, Nloop=1, Nepoch=1, default_batch=16, biased_input=True)
SILENT = lambda m: None


def _spread(tree, scale: float, seed: int):
    """``tree`` ([K, ...] leaves) with a seeded per-client offset of
    ``scale`` times a standard normal draw added to every leaf."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + scale * rng.standard_normal(a.shape)).astype(np.float32),
        tree)


def run_both(jmodel, tmodel, jalgo, talgo, cfg: dict, blocks: int = 2,
             independent: bool = False, spread: float = 0.0,
             replay=None, port_cfg=None) -> dict:
    """Both engines on ``cfg`` (over :data:`BASE`) from the same weights,
    the first ``blocks`` blocks.  ``spread``: start every client from its
    own seeded offset of the common init.  ``replay(tt)`` prepares the port
    trainer before its run (a seam for random streams).  ``port_cfg``:
    fields of the port's config that differ (its obs directory)."""
    cfg = dict(BASE, **cfg)
    with force_comm_kernels_impl("pallas_interpret"):
        jt = JTrainer(jmodel(), JConfig(device_data=False, **cfg),
                      JData(**DATA), jalgo)
        jt.L = blocks
        p0 = jax.tree.map(np.asarray, jt.params0)
        b0 = jax.tree.map(np.asarray, jt.batch_stats0)
        if spread:
            p0 = _spread(p0, spread, seed=7)
            jt.params0 = stage_tree_global(p0, client_sharding(jt.mesh))
        run = jt.run_independent if independent else jt.run
        jstate, jhist = run(log=SILENT)
    tt = TTrainer(tmodel(), TConfig(device="cpu", **dict(cfg, **(port_cfg or {}))),
                  TData(**DATA), talgo)
    tt.L = blocks
    if replay is not None:
        replay(tt)
    start = ClientState(*bridge.classifier_state_from_jax(p0, b0))
    run = tt.run_independent if independent else tt.run
    tstate, thist = run(start, log=SILENT)
    tparams, tstats = bridge.classifier_state_to_jax(tstate.params,
                                                     tstate.batch_stats)
    return dict(jhist=jhist, thist=thist, p0=p0, b0=b0, jt=jt, tt=tt,
                jstate=jstate, tstate=tstate,
                jparams=jax.tree.map(np.asarray, jstate.params),
                jstats=jax.tree.map(np.asarray, jstate.batch_stats),
                tparams=tparams, tstats=tstats)


def moved_modules(p0, params) -> set:
    """The top-level modules of which some leaf differs from ``p0``."""
    return {k for k, leaves in p0.items()
            if any(not np.array_equal(params[k][n], leaves[n])
                   for n in leaves)}


def max_param_diff(a, b) -> float:
    return max(float(np.abs(x - y).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


@contextlib.contextmanager
def torch_threads(n: int):
    """Run the block on ``n`` torch (OpenMP and MKL) threads, then restore
    the count.  A fixed count keeps bitwise comparisons of two port runs
    in one process independent of how a loaded machine schedules threads,
    and one thread keeps many test processes from oversubscribing it."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)
