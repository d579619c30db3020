"""The port's checkpoint format (``utils/checkpoint.py``) and the engine's
mid-run slots.

- A saved tree and meta come back bit for bit (``torch.load`` with
  ``weights_only=True``, ``np.load`` with ``allow_pickle=False``), 0-d
  meta as Python numbers; the history packs and unpacks.
- The checksum catches a changed byte; the swapped saves keep two slots,
  newest first, and a ``.next`` stranded by a crash is promoted by renames
  only; the async writer saves in order and a failure surfaces at
  ``wait``.
- The geometry gate: a K or a device count other than the checkpoint's is
  a ``CheckpointGeometryError`` (not a slot fallback); the JAX package's
  messages for K.
- The engine's slot walk: the newest slot damaged, resume falls back to
  the older one and still ends bit for bit where the uninterrupted run
  ends; every slot damaged, ``CheckpointCorruptError``; a poisoned (NaN)
  slot is skipped like a corrupt one.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from _torch_engine_pair import torch_threads
from federated_pytorch_test_tpu.utils import checkpoint as jckpt
from federated_pytorch_test_tpu_torch.data.cifar10 import FederatedCifar10 as TData
from federated_pytorch_test_tpu_torch.models.simple import Net
from federated_pytorch_test_tpu_torch.train import algorithms as talg
from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
from federated_pytorch_test_tpu_torch.train.engine import (
    BlockwiseFederatedTrainer as TTrainer,
)
from federated_pytorch_test_tpu_torch.utils import checkpoint as ckpt
from federated_pytorch_test_tpu_torch.utils.tree import leaves

TIMING = {"round_seconds", "stage_seconds", "train_seconds", "comm_seconds",
          "ckpt_write_seconds", "accuracy"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module: the port's runs then repeat bit
    for bit, and a loaded machine is not oversubscribed
    (``torch_threads``)."""
    with torch_threads(1):
        yield


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"params/conv1/kernel": torch.randn(4, 3, 5, 5, generator=g),
            "params/fc/bias": torch.randn(7, generator=g),
            "opt/0": torch.tensor(3, dtype=torch.int64),
            "opt/1": torch.arange(4, dtype=torch.int64),
            "z": torch.tensor([np.nan, np.inf, -0.0, 1e-45])}


def _meta():
    return {"nloop": 1, "ci": 2, "mid_block": 1, "guard_scale": float("inf"),
            "members": np.array([True, False, True]),
            "history": ckpt.pack_history([{"loss": 1.5, "n": [1, 2]}])}


def test_tree_and_meta_round_trip_bit_for_bit(tmp_path):
    path = str(tmp_path / "a")
    ckpt.save_checkpoint(path, _tree(), _meta())
    assert sorted(os.listdir(path)) == [ckpt.CHECKSUM_FILE, ckpt.META_FILE,
                                        ckpt.TREE_FILE]
    assert ckpt.verify_checkpoint(path)
    tree, meta = ckpt.load_checkpoint(path)
    for k, v in _tree().items():
        assert tree[k].dtype == v.dtype
        assert torch.equal(tree[k].view(torch.uint8) if v.is_floating_point()
                           else tree[k],
                           v.view(torch.uint8) if v.is_floating_point() else v)
    assert (meta["nloop"], meta["ci"], meta["guard_scale"]) == (1, 2, np.inf)
    assert isinstance(meta["nloop"], int)
    np.testing.assert_array_equal(meta["members"], [True, False, True])
    assert ckpt.unpack_history(meta["history"]) == [{"loss": 1.5, "n": [1, 2]}]
    # a second save replaces the first
    ckpt.save_checkpoint(path, {"z": torch.zeros(2)}, {})
    assert list(ckpt.load_checkpoint(path)[0]) == ["z"]


def test_flatten_and_unflatten_nested_dicts():
    tree = {"a": {"b": torch.ones(2), "c": {"d": torch.zeros(1)}},
            "e": torch.ones(3)}
    flat = ckpt.flatten_dict(tree, "params/")
    assert sorted(flat) == ["params/a/b", "params/a/c/d", "params/e"]
    back = ckpt.unflatten_dict({**flat, "other": torch.ones(1)}, "params/")
    assert back.keys() == tree.keys() and back["a"]["c"]["d"] is \
        tree["a"]["c"]["d"]


def test_checksum_catches_a_changed_byte(tmp_path):
    path = str(tmp_path / "a")
    ckpt.save_checkpoint(path, _tree(), _meta())
    with open(os.path.join(path, ckpt.TREE_FILE), "r+b") as f:
        f.seek(-10, os.SEEK_END)
        b = f.read(1)
        f.seek(-10, os.SEEK_END)
        f.write(bytes([b[0] ^ 1]))
    with pytest.raises(ckpt.CheckpointCorruptError, match="checksum"):
        ckpt.verify_checkpoint(path)
    os.remove(os.path.join(path, ckpt.CHECKSUM_FILE))
    assert ckpt.verify_checkpoint(path) is False


def test_swapped_saves_keep_two_slots_newest_first(tmp_path):
    path = str(tmp_path / "m")
    for i in range(3):
        ckpt.save_checkpoint_swapped(path, {"i": torch.tensor(i)}, {"i": i})
    assert ckpt.checkpoint_slots(path) == [path, path + ".old"]
    assert [ckpt.load_checkpoint(s)[1]["i"] for s in
            ckpt.checkpoint_slots(path)] == [2, 1]
    assert ckpt.finalize_checkpoint(path) == path
    # a crash after the save into .next and before the swap: .next is the
    # newest slot, and the next save promotes it by renames
    ckpt.save_checkpoint(path + ".next", {"i": torch.tensor(3)}, {"i": 3})
    assert ckpt.newest_slot(path) == path + ".next"
    stale = f"{path}{ckpt._TMP_TAG}dead"
    os.makedirs(stale)
    os.utime(stale, (0, 0))
    ckpt.save_checkpoint_swapped(path, {"i": torch.tensor(4)}, {"i": 4})
    assert [ckpt.load_checkpoint(s)[1]["i"] for s in
            ckpt.checkpoint_slots(path)] == [4, 3]
    assert not os.path.exists(stale)
    with pytest.raises(ckpt.NoUsableCheckpointError):
        ckpt.finalize_checkpoint(str(tmp_path / "none"))


def test_async_writer_orders_saves_and_surfaces_failures(tmp_path):
    path = str(tmp_path / "m")
    w = ckpt.AsyncCheckpointWriter()
    for i in range(4):
        w.submit(path, ckpt.snapshot_to_host({"i": torch.tensor(i)}),
                 {"i": i})
    w.wait()
    assert [ckpt.load_checkpoint(s)[1]["i"] for s in
            ckpt.checkpoint_slots(path)] == [3, 2]
    blocker = tmp_path / "file"
    blocker.write_text("x")
    w.submit(str(blocker / "m"), {"i": torch.tensor(0)}, {})
    with pytest.raises(OSError):
        w.wait()
    w.close()
    w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.submit(path, {}, {})


@pytest.mark.parametrize("K,devices,match", [
    (5, 2, "K=4 clients but this run has K=5"),
    (4, 1, "2-device mesh but this run has 1 devices"),
])
def test_geometry_gate(K, devices, match):
    meta = ckpt.mesh_geometry_meta(devices=2, processes=1, K=4)
    with pytest.raises(ckpt.CheckpointGeometryError, match=match):
        ckpt.validate_geometry(meta, devices=devices, processes=1, K=K)
    ckpt.validate_geometry({}, devices=devices, processes=1, K=K)
    if K != 4:
        with pytest.raises(jckpt.CheckpointGeometryError) as jerr:
            jckpt.validate_geometry(
                jckpt.mesh_geometry_meta(devices=2, processes=1, K=4),
                devices=devices, processes=1, K=K)
        with pytest.raises(ckpt.CheckpointGeometryError) as terr:
            ckpt.validate_geometry(meta, devices=devices, processes=1, K=K)
        assert str(terr.value) == str(jerr.value)


DATA = dict(K=4, batch=16, limit_per_client=20, limit_test=16)


def _trainer(K=4, **cfg):
    t = TTrainer(Net(), FederatedConfig(K=K, Nloop=1, Nadmm=2,
                                        default_batch=16, device="cpu",
                                        participation=0.75, **cfg),
                 TData(**dict(DATA, K=K)), talg.AdmmConsensus())
    t.L = 2
    return t


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """An uninterrupted run that saved a mid-run checkpoint every round."""
    path = str(tmp_path_factory.mktemp("ck") / "m")
    state, hist = _trainer().run(log=lambda m: None, checkpoint_path=path)
    return path, state, hist


def _copy(saved, tmp_path):
    path = str(tmp_path / "m")
    for s in ckpt.checkpoint_slots(saved[0]):
        shutil.copytree(s, path + s[len(saved[0]):])
    return path


def _damage(slot):
    with open(os.path.join(slot, ckpt.CHECKSUM_FILE), "w") as f:
        f.write("0" * 64 + "\n")


def test_resume_falls_back_to_the_older_slot(saved, tmp_path):
    path = _copy(saved, tmp_path)
    _damage(path)
    lines = []
    state, hist = _trainer().run(log=lines.append, checkpoint_path=path,
                                 resume=True)
    assert any("unusable" in m for m in lines)
    assert any(m.startswith(f"resumed mid-run checkpoint {path}.old")
               for m in lines)
    strip = lambda h: [{k: v for k, v in r.items() if k not in TIMING}
                       for r in h]
    assert strip(hist) == strip(saved[2])
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(state.params), leaves(saved[1].params)))


def test_every_slot_damaged_is_an_error(saved, tmp_path):
    path = _copy(saved, tmp_path)
    for s in ckpt.checkpoint_slots(path):
        _damage(s)
    with pytest.raises(ckpt.CheckpointCorruptError, match="no valid"):
        _trainer().run(log=lambda m: None, checkpoint_path=path, resume=True)


def test_a_poisoned_slot_is_skipped(saved, tmp_path):
    path = _copy(saved, tmp_path)
    tree, meta = ckpt.load_checkpoint(path)
    name = next(k for k in tree if k.startswith("params/"))
    tree[name] = torch.full_like(tree[name], float("nan"))
    shutil.rmtree(path)
    ckpt.save_checkpoint(path, tree, meta)
    lines = []
    _trainer().run(log=lines.append, checkpoint_path=path, resume=True)
    assert any("non-finite" in m for m in lines)


@pytest.mark.parametrize("K,num_devices", [(2, None), (4, 2)])
def test_resume_on_another_geometry_is_refused(saved, tmp_path, K,
                                               num_devices):
    path = _copy(saved, tmp_path)
    with pytest.raises(ckpt.CheckpointGeometryError):
        _trainer(K=K, num_devices=num_devices).run(
            log=lambda m: None, checkpoint_path=path, resume=True)


def test_resume_without_a_checkpoint_starts_fresh(saved, tmp_path):
    state, hist = _trainer().run(log=lambda m: None,
                                 checkpoint_path=str(tmp_path / "none"),
                                 resume=True)
    assert len(hist) == len(saved[2])
