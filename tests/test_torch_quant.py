"""The port's transport-codec kernels' plain versions and wrappers
(``ops/quant.py``, kernels B1 and B2) against the JAX package's
``ops/comm_kernels.py``.

- B1 plain (``quantize_plain``) vs the JAX reference ``_quantize_xla`` run
  eagerly: scale and q bitwise.  Vs the Pallas ``_quantize_pallas`` in
  interpret mode under ``jit``: scale within 1 ulp and q within ±1 on a few
  elements.  Under ``jit`` XLA on the CPU computes the scale as
  ``max * (1/qmax)``, which is one ulp off the IEEE quotient for about 4.5%
  of the rows at qmax 127 (55-60% at qmax 7); the per-element division
  stays IEEE, so q moves only where ``v / safe`` lies within an ulp of a
  half-integer: 0-1 of 2.36M elements at the path's shape.
- B2 plain (``dequant_add_plain``) vs ``_dequant_add_xla`` eagerly: bitwise.
  Vs the interpret kernel under ``jit``: within 1 ulp of the larger of the
  result and the product ``q * safe``, since XLA contracts
  ``acc + q * safe`` into a fused multiply-add there (about a quarter of
  the outputs differ from the two roundings; where acc and the product
  cancel, the product's rounding sets the difference).
- The wrappers: a CPU tensor takes the plain version and adds no launch; a
  tensor on another device raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.ops.comm_kernels import (
    _dequant_add_pallas,
    _dequant_add_xla,
    _quantize_pallas,
    _quantize_xla,
)
from federated_pytorch_test_tpu_torch.ops import quant

#: (rows, chunk) cases: widths 2, 64, 256 and a ragged row count
SHAPES = [(5, 2), (33, 64), (9, 256), (70, 256)]


def _rows(c, w, seed, zero_row=True, saturate=True):
    """Unit-normal rows with a zero row and a row dominated by one value
    (every other entry rounds to 0, the big one to ±qmax)."""
    v = np.random.default_rng(seed).normal(size=(c, w)).astype(np.float32)
    if zero_row and c > 1:
        v[1] = 0.0
    if saturate and c > 2:
        v[2] *= 1e-6
        v[2, w // 2] = -50.0
    return v


def _ulps(a, b):
    """Distance in float32 units of the last place (same-sign values)."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("c,w", SHAPES)
def test_quantize_plain_matches_xla_eagerly(c, w, qmax):
    v = _rows(c, w, seed=c * 31 + w)
    jq, js = _quantize_xla(jnp.asarray(v), qmax)
    tq, ts = quant.quantize_plain(torch.from_numpy(v), qmax)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts[1] == 0 and (tq[1] == 0).all()                  # zero row
    if c > 2:
        assert tq[2, w // 2] == -qmax and (tq[2].abs().sum() == qmax)


@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("c,w", SHAPES + [(2048, 256)])
def test_quantize_plain_matches_pallas_interpret_under_jit(c, w, qmax):
    v = _rows(c, w, seed=c * 37 + w)
    jq, js = jax.jit(lambda a: _quantize_pallas(a, qmax, interpret=True))(
        jnp.asarray(v))
    tq, ts = quant.quantize_plain(torch.from_numpy(v), qmax)
    assert _ulps(ts.numpy(), np.asarray(js)).max() <= 1
    dq = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32))
    assert dq.max() <= 1
    assert int((dq > 0).sum()) <= max(2, v.size // 100_000)


def test_dequant_add_plain_matches_xla_eagerly():
    rng = np.random.default_rng(3)
    acc = rng.normal(size=(70, 256)).astype(np.float32)
    q = rng.integers(-127, 128, size=(70, 256)).astype(np.int8)
    scale = np.abs(rng.normal(size=70)).astype(np.float32) / 127
    scale[[0, 5]] = 0.0                                 # zero-scale rows
    want = np.asarray(_dequant_add_xla(jnp.asarray(acc), jnp.asarray(q),
                                       jnp.asarray(scale)))
    got = quant.dequant_add_plain(torch.from_numpy(acc), torch.from_numpy(q),
                                  torch.from_numpy(scale)).numpy()
    np.testing.assert_array_equal(got, want)
    # a zero scale decodes with safe = 1: acc + q
    np.testing.assert_array_equal(got[0], acc[0] + q[0].astype(np.float32))


@pytest.mark.parametrize("c,w", [(5, 2), (33, 64), (70, 256)])
def test_dequant_add_plain_within_an_ulp_of_pallas_interpret(c, w):
    rng = np.random.default_rng(c + w)
    acc = rng.normal(size=(c, w)).astype(np.float32)
    q = rng.integers(-127, 128, size=(c, w)).astype(np.int8)
    scale = np.abs(rng.normal(size=c)).astype(np.float32) / 127
    scale[0] = 0.0
    zq = np.zeros_like(q)
    want = np.asarray(jax.jit(lambda a, b, s: _dequant_add_pallas(
        a, b, s, interpret=True))(jnp.asarray(acc), jnp.asarray(q),
                                  jnp.asarray(scale)))
    got = quant.dequant_add_plain(torch.from_numpy(acc), torch.from_numpy(q),
                                  torch.from_numpy(scale)).numpy()
    # one ulp of the larger of the result and the product: where acc and
    # q * safe cancel, the product's own rounding is the larger one
    prod = q.astype(np.float32) * np.where(scale > 0, scale, 1)[:, None]
    ulp = np.spacing(np.maximum(np.abs(want), np.abs(prod)))
    assert (np.abs(got - want) <= ulp).all()
    assert int((got != want).sum()) <= got.size // 2
    # where q is 0 the accumulate passes acc through on both sides
    passthru = quant.dequant_add_plain(torch.from_numpy(acc),
                                       torch.from_numpy(zq),
                                       torch.from_numpy(scale)).numpy()
    np.testing.assert_array_equal(passthru, acc)


@pytest.mark.parametrize("qmax", [127, 7])
def test_quantize_wrapper_takes_the_plain_version_on_the_cpu(qmax):
    v = torch.from_numpy(_rows(33, 64, seed=5))
    before = dict(quant.LAUNCHES)
    q, s = quant.quantize_chunks(v, qmax)
    pq, ps = quant.quantize_plain(v, qmax)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    acc = torch.randn(33, 64, generator=torch.Generator().manual_seed(0))
    assert torch.equal(quant.dequant_add(acc, q, s),
                       quant.dequant_add_plain(acc, q, s))
    assert quant.LAUNCHES == before


def test_wrappers_refuse_other_devices():
    v = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        quant.quantize_chunks(v, 127)
    with pytest.raises(ValueError, match="CUDA device"):
        quant.dequant_add(v, torch.zeros(4, 8, dtype=torch.int8),
                          torch.zeros(4))


def test_kernels_and_plain_sets():
    assert quant.KERNELS.quantize is quant.quantize_chunks
    assert quant.KERNELS.dequant_add is quant.dequant_add
    assert quant.PLAIN.quantize is quant.quantize_plain
    assert quant.PLAIN.dequant_add is quant.dequant_add_plain
    assert set(quant.LAUNCHES) == {"quantize_chunks", "dequant_add"}
