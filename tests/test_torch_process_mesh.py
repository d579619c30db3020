"""The rank mesh: the client mesh spread over two gloo ranks on the CPU.

Every collective of :class:`RankMesh` (``psum``, the tiled and untiled
``all_gather``, ``all_to_all``, ``ppermute`` on a shift and an exchange
permutation, the reduce-scatter, the row gather) at D = 2 and 4, the
packed fused mean (plain versions) at D = 2 and 4 (butterfly) and 6
(ring, three shards a rank), the robust estimators (the chunked krum and
trim, the dense krum over the gathered stack) at D = 2, 4 and 6,
``sharded_federated_mean``, ``per_client_norms`` and ``all_clients_dot``:
each held bit for bit against the one-process :class:`ClientMesh` at the
same D, on both ranks.  The sharded mean, the norms and the dot are held
against the JAX package's inside ``shard_map`` on the virtual CPU mesh
too, within the tolerance of ``test_sharded_mean_matches_jax`` (rtol
2e-5, atol 1e-6), and ``robust_gather_bytes`` equals JAX's.  One rank
launch runs every case (``bundle``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_ranks import (
    norm_inputs,
    run_local,
    run_ranks,
    sharded_inputs,
)
from jax.sharding import PartitionSpec as P

from federated_pytorch_test_tpu.parallel import comm as jcomm
from federated_pytorch_test_tpu.parallel.mesh import (
    CLIENT_AXIS,
    client_mesh,
    client_sharding,
    shard_map,
)
from federated_pytorch_test_tpu_torch.parallel import comm as tcomm

COLLECTIVES = [2, 4]
PACKED = [(D, weighted) for D in (2, 4, 6) for weighted in (False, True)]
ROBUST = [(D, kind, chunked) for D in (2, 4, 6)
          for kind, chunked in (("krum", True), ("trim", True),
                                ("krum", False))]
SHARDED = [(D, w) for D in (2, 4) for w in ("none", "some", "all_rejected")]
NORMS = [2, 4]

CALLS = ([["collectives", dict(D=D)] for D in COLLECTIVES]
         + [["packed_mean", dict(D=D, weighted=w)] for D, w in PACKED]
         + [["robust", dict(D=D, kind=k, chunked=c)] for D, k, c in ROBUST]
         + [["sharded", dict(D=D, weights=w)] for D, w in SHARDED]
         + [["norms", dict(D=D)] for D in NORMS])


def _index(name, **kw):
    return CALLS.index([name, kw])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("mesh"), "bundle", calls=CALLS,
                     timeout=120)


def _local(name, **kw):
    return run_local(name, **kw)


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b), float(np.abs(a - b).max())


@pytest.mark.parametrize("D", COLLECTIVES)
def test_collectives_match_one_process(ranks, D):
    """Replicated results agree on both ranks; each device's share (its
    slab, its received part, its reduced segment) is the one-process
    mesh's for that device."""
    want = _local("collectives", D=D)
    r0, r1 = (r[_index("collectives", D=D)] for r in ranks)
    rep = [k for k in want if k[1] == -1]
    for k in rep:
        _same(r0[k], want[k])
        _same(r1[k], want[k])
    per_device = {**{k: v for k, v in r0.items() if k[1] >= 0},
                  **{k: v for k, v in r1.items() if k[1] >= 0}}
    assert set(per_device) == {k for k in want if k[1] >= 0}
    for k, v in per_device.items():
        _same(v, want[k])
    # each rank holds only its own devices' shares
    assert {k[1] for k in r0 if k[1] >= 0} == set(range(D // 2))


@pytest.mark.parametrize("D,weighted", PACKED)
def test_packed_fused_mean_matches_one_process(ranks, D, weighted):
    want = _local("packed_mean", D=D, weighted=weighted)
    for r in ranks:
        _same(r[_index("packed_mean", D=D, weighted=weighted)], want)


@pytest.mark.parametrize("D,kind,chunked", ROBUST)
def test_robust_estimators_match_one_process(ranks, D, kind, chunked):
    want = _local("robust", D=D, kind=kind, chunked=chunked)
    assert np.isfinite(want).all()
    for r in ranks:
        _same(r[_index("robust", D=D, kind=kind, chunked=chunked)], want)


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


@pytest.mark.parametrize("D,weights", SHARDED)
def test_sharded_mean_matches_jax_and_one_process(ranks, D, weights):
    x, w = sharded_inputs(weights)
    want = _local("sharded", D=D, weights=weights)
    np.testing.assert_allclose(want, _jax_sharded(x, w, D), rtol=2e-5,
                               atol=1e-6)
    for r in ranks:
        _same(r[_index("sharded", D=D, weights=weights)], want)
    if weights == "all_rejected":
        assert not want.any()


@pytest.mark.parametrize("D", NORMS)
def test_norms_and_dot_match_jax_and_one_process(ranks, D):
    a, b, ref = norm_inputs()
    mesh = client_mesh(D)
    csh = client_sharding(mesh)
    put = lambda v: jax.device_put(jnp.asarray(v), csh)
    jn = jax.jit(shard_map(lambda s: jcomm.per_client_norms(s, ref),
                           mesh=mesh, in_specs=(P(CLIENT_AXIS),),
                           out_specs=P(CLIENT_AXIS)))(put(a))
    jd = jax.jit(shard_map(jcomm.all_clients_dot, mesh=mesh,
                           in_specs=(P(CLIENT_AXIS), P(CLIENT_AXIS)),
                           out_specs=P(), check_vma=False))(put(a), put(b))
    want = _local("norms", D=D)
    np.testing.assert_allclose(want["norms"], np.asarray(jn), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(want["dot"], np.asarray(jd), rtol=2e-5,
                               atol=1e-6)
    for r in ranks:
        _same(r[_index("norms", D=D)], want)


@pytest.mark.parametrize("kind", ["none", "trim", "krum", "geomed"])
@pytest.mark.parametrize("chunked,D", [(False, 1), (False, 4), (True, 1),
                                       (True, 4), (True, 3)])
def test_robust_gather_bytes_matches_jax(kind, chunked, D):
    for n in (301, 4_720_640):
        assert tcomm.robust_gather_bytes(kind, 10, n, D, chunked) == \
            jcomm.robust_gather_bytes(kind, 10, n, D, chunked)
