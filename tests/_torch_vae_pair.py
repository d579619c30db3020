"""Run the JAX VAE trainers and the port's on the same start.

Both sides get the same synthetic CIFAR-10 shards, the JAX trainer's
common init (carried across with ``bridge.py``) and the JAX engine's
reparametrisation draws (replayed through the port's ``normal`` seam, with
``tests/_torch_jax_draws.py``); the JAX side pins ``device_data=False``.
:func:`run_both` returns both histories and final states, the port's as
numpy trees in the JAX layout; :func:`run_port_driver` runs a port driver
through its ``main`` from the same start.
"""

import jax
import numpy as np

from _torch_jax_draws import replay_noise
from federated_pytorch_test_tpu.data.cifar10 import FederatedCifar10 as JData
from federated_pytorch_test_tpu.train import FederatedConfig as JConfig
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu_torch import bridge
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10 as TData
from federated_pytorch_test_tpu_torch.train import algorithms as talg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig as TConfig
from federated_pytorch_test_tpu_torch.train.engine import ClientState

K = 2
#: 40 images per client in batches of 16: the last batch of every epoch
#: has 8 pad rows; 32 test images, two batches
DATA = dict(K=K, batch=16, limit_per_client=40, limit_test=32)
SILENT = lambda m: None


def run_both(jtrainer, ttrainer, jmodel, tmodel, cfg: dict, blocks=None,
             biased_input: bool = True, prepare=None) -> dict:
    """Both trainers (FedAvg) on ``cfg`` from the same weights and noise,
    the first ``blocks`` sweep units (all by default).  ``prepare(jt,
    tt)`` sees both trainers before they run."""
    cfg = dict(K=K, Nloop=1, Nepoch=1, default_batch=16,
               biased_input=biased_input, **cfg)
    data = dict(DATA, biased_input=biased_input)
    # the JAX model's init traced once instead of run op by op (some 90
    # small compiles); its values are the common init of both sides
    object.__setattr__(jmodel, "init_variables",
                       jax.jit(jmodel.init_variables))
    jt = jtrainer(jmodel, JConfig(device_data=False, **cfg), JData(**data),
                  jalg.FedAvg())
    tt = ttrainer(tmodel, TConfig(device="cpu", **cfg), TData(**data),
                  talg.FedAvg())
    if blocks is not None:
        jt.L = tt.L = blocks
    if prepare is not None:
        prepare(jt, tt)
    p0 = jax.tree.map(np.asarray, jt.params0)
    jstate, jhist = jt.run(log=SILENT)
    tt.normal = replay_noise(K)
    tstate, thist = tt.run(
        ClientState(bridge.tree_from_jax(p0, stacked=True), {}), log=SILENT)
    return dict(jhist=jhist, thist=thist, p0=p0, jt=jt, tt=tt,
                jstate=jstate, tstate=tstate,
                jparams=jax.tree.map(np.asarray, jstate.params),
                tparams=bridge.tree_to_jax(tstate.params, stacked=True))


def max_diff(a, b) -> float:
    """Largest elementwise difference of two trees of arrays."""
    return max(float(np.abs(x - y).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def run_port_driver(monkeypatch, module, p0, argv):
    """``module.main(argv)`` (a port driver) with its trainer made to start
    from the JAX init ``p0`` and draw the JAX noise; returns its history
    and final parameters as a numpy tree in the JAX layout."""
    build = module.build

    def from_jax(argv):
        trainer = build(argv)
        trainer.params0 = bridge.tree_from_jax(p0, stacked=True,
                                               device=trainer.device)
        trainer.normal = replay_noise(trainer.cfg.K)
        return trainer

    monkeypatch.setattr(module, "build", from_jax)
    trainer, state, hist = module.main(argv, log=SILENT)
    return hist, bridge.tree_to_jax(state.params, stacked=True)


def driver_argv(K: int, *extra: str) -> list:
    """A port driver's flags for the sizes of :func:`run_both`."""
    return ["--device", "cpu", "--K", str(K), "--Nloop", "1", "--Nadmm", "1",
            "--n-train", str(DATA["limit_per_client"]),
            "--n-test", str(DATA["limit_test"]),
            "--default-batch", str(DATA["batch"]), "--check-results", *extra]


def same_rounds(a: list, b: list) -> bool:
    """Two histories with the same blocks, sizes, losses, dual residuals
    and per-client evaluations, bit for bit."""
    keys = ("block", "N", "loss", "dual_residual", "accuracy")
    return len(a) == len(b) and all(
        np.array_equal(np.asarray(x[k]), np.asarray(y[k]))
        for x, y in zip(a, b) for k in keys)
