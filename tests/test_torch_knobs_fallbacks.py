"""The throughput knobs' gating against the JAX engine's, and the sharded
mean against JAX's.

Every fall-back of the JAX engine (``fused_rounds`` without device data,
under ``be_verbose`` or population; ``overlap_round`` under the fused
round, the update guard, async rounds, faults, a campaign or population)
warns with the JAX message and runs the plain loop; every refusal
(``device_data=True`` under population or on a pipeline without
``train_shards_raw``, ``sharded_update`` with a robust estimator or on
the CPC trainer) raises the JAX message.

The JAX package's ``sharded_federated_mean`` inside ``shard_map`` on the
virtual CPU mesh at D = 2 and 3, K = 6, N = 301 (padded to D segments),
against the mean that serves ``--sharded-update`` in the port on its
one-card mesh, the replicated ``_active_mean``: with no weights, with
weights and with every client rejected, within rtol 2e-5 (the JAX
package's declared band against the replicated mean).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cpc_pair import FILES2, SAPS2, jax_trainer, port_trainer
from _torch_engine_pair import DATA, K
from jax.sharding import PartitionSpec as P

from federated_pytorch_test_tpu.data.cifar10 import FederatedCifar10 as JData
from federated_pytorch_test_tpu.models.simple import Net as JNet
from federated_pytorch_test_tpu.parallel import comm as jcomm
from federated_pytorch_test_tpu.parallel.mesh import (
    CLIENT_AXIS,
    client_mesh,
    client_sharding,
    shard_map,
)
from federated_pytorch_test_tpu.train import algorithms as jalg
from federated_pytorch_test_tpu.train import (
    BlockwiseFederatedTrainer as JTrainer,
    FederatedConfig as JConfig,
)
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10 as TData
from federated_pytorch_test_tpu_torch.models.simple import Net as TNet
from federated_pytorch_test_tpu_torch.parallel.mesh import ClientMesh
from federated_pytorch_test_tpu_torch.train import algorithms as talg
from federated_pytorch_test_tpu_torch.train.algorithms import _active_mean
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig as TConfig
from federated_pytorch_test_tpu_torch.train.engine import (
    BlockwiseFederatedTrainer as TTrainer,
)

BASE = dict(K=K, Nloop=1, Nadmm=2, default_batch=16, check_results=False)
POP = dict(population=8)


class NoShards:
    """A data pipeline without ``train_shards_raw``."""

    def __init__(self, data):
        self._data = data

    def __getattr__(self, name):
        if name == "train_shards_raw":
            raise AttributeError(name)
        return getattr(self._data, name)


#: (knobs, the flag the engine leaves off after the warning)
WARNS = {
    "fused_without_device_data": (dict(fused_rounds=True, device_data=False),
                                  "_use_fused"),
    "fused_be_verbose": (dict(fused_rounds=True, device_data=True,
                              be_verbose=True), "_use_fused"),
    "fused_population": (dict(fused_rounds=True, **POP), "_use_fused"),
    "overlap_round_fused": (dict(overlap_round=True, fused_rounds=True,
                                 device_data=True), "_overlap_round"),
    "overlap_round_guard": (dict(overlap_round=True, update_guard=True),
                            "_overlap_round"),
    "overlap_round_async": (dict(overlap_round=True, async_rounds=True),
                            "_overlap_round"),
    "overlap_round_faults": (dict(overlap_round=True,
                                  fault_spec="drop=0.2,seed=1"),
                             "_overlap_round"),
    "overlap_round_campaign": (dict(overlap_round=True, campaign_spec=(
        "hours=2,round_minutes=30,drop=0.1,seed=2")), "_overlap_round"),
    "overlap_round_population": (dict(overlap_round=True, **POP),
                                 "_overlap_round"),
}
RAISES = {
    "device_data_population": dict(device_data=True, **POP),
    "device_data_no_shards": dict(device_data=True),
    "sharded_robust": dict(sharded_update=True, robust_agg="trim"),
}


def _build(side: str, knobs: dict, name: str):
    JD, TD = ((NoShards(JData(**DATA)), NoShards(TData(**DATA)))
              if name == "device_data_no_shards" else
              (JData(**DATA), TData(**DATA)))
    if side == "jax":
        return JTrainer(JNet(), JConfig(**BASE, **knobs), JD,
                        jalg.AdmmConsensus())
    return TTrainer(TNet(), TConfig(device="cpu", **BASE, **knobs), TD,
                    talg.AdmmConsensus())


def _fallbacks(side: str, knobs: dict, name: str):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t = _build(side, knobs, name)
    return t, [str(w.message) for w in caught
               if "requested but" in str(w.message)]


@pytest.mark.parametrize("name", [*WARNS, *RAISES, "sharded_cpc"])
def test_fallbacks_and_refusals_are_the_jax_engines(name):
    if name == "sharded_cpc":
        with pytest.raises(ValueError) as jerr:
            jax_trainer(FILES2, SAPS2, sharded_update=True)
        with pytest.raises(ValueError) as terr:
            port_trainer(FILES2, SAPS2, sharded_update=True)
        assert str(terr.value) == str(jerr.value)
        return
    if name in RAISES:
        with pytest.raises(ValueError) as jerr:
            _build("jax", RAISES[name], name)
        with pytest.raises(ValueError) as terr:
            _build("port", RAISES[name], name)
        assert str(terr.value) == str(jerr.value)
        return
    knobs, flag = WARNS[name]
    jt, jw = _fallbacks("jax", knobs, name)
    tt, tw = _fallbacks("port", knobs, name)
    assert len(jw) == 1 and tw == jw
    assert getattr(jt, flag) is False and getattr(tt, flag) is False
    tt.close()


def _jax_sharded(x, w, D):
    mesh = client_mesh(D)
    csh = client_sharding(mesh)
    f = shard_map(
        lambda xs, ws: jcomm.sharded_federated_mean(
            xs, None if w is None else ws, K=x.shape[0], D=D),
        mesh=mesh, in_specs=(P(CLIENT_AXIS), P(CLIENT_AXIS)), out_specs=P(),
        check_vma=False)
    ww = np.ones(x.shape[0], np.float32) if w is None else w
    return np.asarray(jax.jit(f)(jax.device_put(jnp.asarray(x), csh),
                                 jax.device_put(jnp.asarray(ww), csh)))


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("weights", ["none", "some", "all_rejected"])
def test_sharded_mean_matches_jax(D, weights):
    rng = np.random.default_rng(20 + D)
    x = rng.normal(size=(6, 301)).astype(np.float32)
    w = {"none": None,
         "some": np.array([1, 0, 0.5, 1, 0, 0.25], np.float32),
         "all_rejected": np.zeros(6, np.float32)}[weights]
    want = _jax_sharded(x, w, D)
    tw = None if w is None else torch.from_numpy(w)
    got = _active_mean(torch.from_numpy(x), tw, 6, ClientMesh(D))
    assert got.shape == (301,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-6)
    if weights == "all_rejected":
        assert not got.any()
