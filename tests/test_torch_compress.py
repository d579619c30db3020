"""The port's compressors and transport codec (``compress/``,
``ops/packed_reduce.py`` pack/unpack) against the JAX package.

- ``pack_chunks``/``unpack_chunks`` (q8 and q4): bytes and scales equal to
  the JAX functions run eagerly; the decode equal.
- ``StochasticQuantizer.encode`` with the JAX uniform draws handed to the
  port (its ``uniform`` seam): q and scale equal to JAX's eager encode, two
  rounds in a row (the key stream advances); ``decode`` equal.
- ``ErrorFeedback``: the residual after two rounds within 1e-7 of JAX's
  (``u - decode(encode(u))`` of equal payloads, the same float32
  operations); a JAX residual carried over with ``bridge.ef_state_from_jax``.
- ``bytes_on_wire`` and ``transport_params`` equal for a table of n;
  ``make_compressor``'s validation equal, and ``topk`` "not ported".
- ``compressed_federated_mean`` (decode, then the mean over a 2-shard
  mesh) on the same payload bytes as the JAX function under ``shard_map``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_jax_draws import jax_block_keys, replay
from federated_pytorch_test_tpu.compress import make_compressor as j_make
from federated_pytorch_test_tpu.ops import packed_reduce as jpr
from federated_pytorch_test_tpu.parallel.comm import (
    compressed_federated_mean as j_mean,
)
from federated_pytorch_test_tpu.parallel.mesh import (
    CLIENT_AXIS,
    client_mesh,
    client_sharding,
    shard_map,
)
from federated_pytorch_test_tpu_torch import bridge
from federated_pytorch_test_tpu_torch.compress import base as tbase
from federated_pytorch_test_tpu_torch.compress.error_feedback import (
    ErrorFeedback,
)
from federated_pytorch_test_tpu_torch.compress.quantize import (
    StochasticQuantizer,
)
from federated_pytorch_test_tpu_torch.ops import packed_reduce as tpr
from federated_pytorch_test_tpu_torch.parallel.comm import (
    compressed_federated_mean as t_mean,
)
from federated_pytorch_test_tpu_torch.parallel.mesh import ClientMesh


def _vec(n, seed):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("chunk", [2, 64, 256])
def test_pack_unpack_byte_equal(bits, chunk):
    v = _vec(chunk * 7, seed=bits * 100 + chunk)
    v[:chunk] = 0.0                                         # a zero chunk
    jq, js = jpr.pack_chunks(jnp.asarray(v), chunk, bits)
    tq, ts = tpr.pack_chunks(torch.from_numpy(v), chunk, bits)
    assert tq.dtype == (torch.uint8 if bits == 4 else torch.int8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tpr.unpack_chunks(tq, ts, chunk, bits).numpy(),
        np.asarray(jpr.unpack_chunks(jq, js, chunk, bits)))


def _states(comp, jcomp, K, n, seed):
    """The port's fresh state and JAX's (from the same block seed), with
    the JAX draws handed to the port's quantizer."""
    jkeys = jax_block_keys(seed, K)
    tstate = tbase.stacked_init(comp, K, n, seed, "cpu")
    inner = getattr(comp, "inner", comp)
    seeds = (tstate["inner"] if inner is not comp else tstate)["seed"]
    inner.uniform = replay(seeds.tolist(), jkeys)
    return tstate, [jcomp.init_state(n, jkeys[k]) for k in range(K)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n", [1, 300, 1024])
def test_stochastic_encode_matches_jax_with_its_draws(bits, n):
    K, chunk = 3, 128
    comp = StochasticQuantizer(bits, chunk)
    jcomp = j_make(f"q{bits}", quant_chunk=chunk)
    tstate, jstates = _states(comp, jcomp, K, n, seed=7)
    for rnd in range(2):
        vecs = np.stack([_vec(n, 10 * rnd + k) * (k + 1) for k in range(K)])
        payload, tstate = comp.encode(torch.from_numpy(vecs), tstate)
        dec = comp.decode(payload, n)
        assert dec.shape == (K, n)
        for k in range(K):
            jp, jstates[k] = jcomp.encode(jnp.asarray(vecs[k]), jstates[k])
            np.testing.assert_array_equal(payload["q"][k].numpy(),
                                          np.asarray(jp["q"]))
            np.testing.assert_array_equal(payload["scale"][k].numpy(),
                                          np.asarray(jp["scale"]))
            np.testing.assert_array_equal(dec[k].numpy(),
                                          np.asarray(jcomp.decode(jp, n)))
    assert tstate["count"].tolist() == [2] * K


def test_error_feedback_residual_matches_jax():
    K, n, chunk = 2, 500, 64
    comp = tbase.make_compressor("q4", quant_chunk=chunk, error_feedback=True)
    assert isinstance(comp, ErrorFeedback) and comp.name == "q4+ef"
    jcomp = j_make("q4", quant_chunk=chunk, error_feedback=True)
    tstate, jstates = _states(comp, jcomp, K, n, seed=3)
    for rnd in range(2):
        vecs = np.stack([_vec(n, 50 + 10 * rnd + k) for k in range(K)])
        payload, tstate = comp.encode(torch.from_numpy(vecs), tstate)
        for k in range(K):
            jp, jstates[k] = jcomp.encode(jnp.asarray(vecs[k]), jstates[k])
            np.testing.assert_array_equal(payload["q"][k].numpy(),
                                          np.asarray(jp["q"]))
            np.testing.assert_allclose(tstate["resid"][k].numpy(),
                                       np.asarray(jstates[k]["resid"]),
                                       rtol=0, atol=1e-7)
    # a JAX residual carried over: the next encode agrees again
    jres = np.stack([np.asarray(s["resid"]) for s in jstates])
    tstate = bridge.ef_state_from_jax(jres, tstate)
    np.testing.assert_array_equal(tstate["resid"].numpy(), jres)
    vecs = np.stack([_vec(n, 90 + k) for k in range(K)])
    payload, tstate = comp.encode(torch.from_numpy(vecs), tstate)
    for k in range(K):
        jp, jstates[k] = jcomp.encode(jnp.asarray(vecs[k]), jstates[k])
        np.testing.assert_array_equal(payload["q"][k].numpy(),
                                      np.asarray(jp["q"]))
    reset = comp.reset_state(tstate)
    assert not reset["resid"].any()
    assert reset["inner"]["count"].tolist() == [3] * K
    with pytest.raises(ValueError, match="shape"):
        bridge.ef_state_from_jax(jres[:, :10], tstate)


@pytest.mark.parametrize("name,ef", [("none", False), ("q8", False),
                                     ("q4", False), ("q8", True), ("q4", True)])
def test_bytes_and_transport_match_jax(name, ef):
    for chunk in (2, 64, 256):
        j = j_make(name, quant_chunk=chunk, error_feedback=ef)
        t = tbase.make_compressor(name, quant_chunk=chunk, error_feedback=ef)
        assert t.name == j.name
        assert tpr.transport_params(t) == jpr.transport_params(j)
        for n in (1, 2, 255, 256, 257, 1856, 4_720_640):
            assert t.bytes_on_wire(n) == j.bytes_on_wire(n)


@pytest.mark.parametrize("kw", [
    dict(name="zip"),
    dict(name="none", error_feedback=True),
    dict(name="q8", quant_chunk=3),
    dict(name="q4", quant_chunk=0),
])
def test_make_compressor_validation_matches_jax(kw):
    kw = dict(kw)
    name = kw.pop("name")
    with pytest.raises(ValueError) as jerr:
        j_make(name, **kw)
    with pytest.raises(ValueError) as terr:
        tbase.make_compressor(name, **kw)
    assert str(terr.value) == str(jerr.value)


def test_topk_is_not_ported():
    """Top-k is ported now: the factory builds it, wrapped in error
    feedback when asked, with the JAX package's names, sparse flag, frac
    and byte count (``tests/test_torch_topk.py`` holds the codec itself
    against JAX)."""
    for ef in (False, True):
        t = tbase.make_compressor("topk", topk_frac=0.05, error_feedback=ef)
        j = j_make("topk", topk_frac=0.05, error_feedback=ef)
        assert t.name == j.name == ("topk+ef" if ef else "topk")
        assert t.sparse and j.sparse
        assert (t.inner if ef else t).frac == 0.05
        assert t.bytes_on_wire(1000) == j.bytes_on_wire(1000) == 400
    assert tbase.COMPRESS_CHOICES == ("none", "q8", "q4", "topk")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("weighted", [False, True])
def test_compressed_federated_mean_matches_jax(bits, weighted):
    """The decode-then-sum mean of q8/q4 payloads over a 2-shard mesh,
    against the JAX function under ``shard_map`` (the same payload bytes on
    both sides): float32 sums in the same order, rtol 1e-6."""
    K, n, chunk = 4, 300, 64
    jcomp = j_make(f"q{bits}", quant_chunk=chunk)
    keys = jax_block_keys(1, K)
    vecs = np.stack([_vec(n, 200 + k) for k in range(K)])
    pays = [jcomp.encode(jnp.asarray(vecs[k]), jcomp.init_state(n, keys[k]))[0]
            for k in range(K)]
    q = np.stack([np.asarray(p["q"]) for p in pays])
    s = np.stack([np.asarray(p["scale"]) for p in pays])
    w = np.array([1, 0, 1, 1], np.float32) if weighted else None
    mesh = client_mesh(2)
    csh = client_sharding(mesh)
    fn = shard_map(lambda qq, ss, ww: j_mean(
        {"q": qq, "scale": ss}, jcomp, n, K, w=ww if weighted else None),
        mesh=mesh, in_specs=(P(CLIENT_AXIS),) * 3, out_specs=P(),
        check_vma=False)
    want = np.asarray(jax.jit(fn)(
        *(jax.device_put(jnp.asarray(a), csh)
          for a in (q, s, np.ones(K, np.float32) if w is None else w))))
    comp = tbase.make_compressor(f"q{bits}", quant_chunk=chunk)
    got = t_mean({"q": torch.from_numpy(q), "scale": torch.from_numpy(s)},
                 comp, n, K, ClientMesh(2),
                 None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
