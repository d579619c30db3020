"""The port's VAE losses (``train/vae_losses.py``) against the JAX
package's, on seeded inputs: ``vae_loss``, ``cost1``, ``cost2``,
``cost21``, ``cost3`` and ``vae_cl_loss``, each unweighted, with all-one
weights and with a partial batch (the last rows weighted 0, as the pad
rows of a wrap-padded minibatch are).

- Tolerance: rtol 1e-5 (float32 sums in other orders; images NCHW in the
  port, NHWC in JAX).
- The pad rows' values do not matter: changing them leaves the weighted
  losses unchanged.
- The clustering costs on [Kc, B] responsibilities equal the JAX costs of
  each cluster, and ``vae_cl_loss`` equals JAX's at Kc = 1, 4 and 10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.train import vae_losses as jl
from federated_pytorch_test_tpu_torch.train import vae_losses as tl

RTOL = 1e-5
B, KC, L = 6, 4, 5
WEIGHTS = {"none": None, "ones": np.ones(B, np.float32),
           "partial": np.array([1, 1, 1, 1, 0, 0], np.float32)}


def _inputs(seed: int, kc: int = KC):
    """JAX-layout inputs of one batch: images [B, 4, 4, 3], the model's
    per-cluster outputs [kc, B, ...] and ekhat [B, kc]."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    pos = lambda *s: np.log1p(np.exp(f(*s))).astype(np.float32)
    e = np.exp(f(B, kc))
    return dict(
        x=r.uniform(0, 1, (B, 4, 4, 3)).astype(np.float32),
        recon=r.uniform(0, 1, (B, 4, 4, 3)).astype(np.float32),
        mu=f(B, L), logvar=0.3 * f(B, L),
        ekhat=(e / e.sum(1, keepdims=True)).astype(np.float32),
        mu_xi=f(kc, B, L), sig2_xi=pos(kc, B, L), mu_b=f(kc, B, L),
        sig2_b=pos(kc, B, L), mu_th=f(kc, B, 4, 4, 3),
        sig2_th=pos(kc, B, 4, 4, 3))


def _t(a, image: bool = False):
    t = torch.from_numpy(np.array(a))
    return t.movedim(-1, -3) if image else t


def _w(name):
    w = WEIGHTS[name]
    return (None, None) if w is None else (w, torch.from_numpy(w))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL)


@pytest.mark.parametrize("wname", list(WEIGHTS))
def test_vae_loss(wname):
    d = _inputs(0)
    jw, tw = _w(wname)
    want = jl.vae_loss(d["recon"], d["x"], d["mu"], d["logvar"], jw)
    got = tl.vae_loss(_t(d["recon"], True), _t(d["x"], True), _t(d["mu"]),
                      _t(d["logvar"]), tw)
    _close(got, want)


@pytest.mark.parametrize("wname", list(WEIGHTS))
def test_cluster_costs_one_cluster(wname):
    d = _inputs(1)
    jw, tw = _w(wname)
    for k in range(KC):
        pk = d["ekhat"][:, k]
        tpk = _t(pk)
        _close(tl.cost1(tpk, _t(d["mu_th"][k], True), _t(d["sig2_th"][k], True),
                        _t(d["x"], True), tw),
               jl.cost1(pk, d["mu_th"][k], d["sig2_th"][k], d["x"], jw))
        _close(tl.cost2(tpk, tw), jl.cost2(pk, jw))
        _close(tl.cost21(tpk, tw), jl.cost21(pk, jw))
        _close(tl.cost3(tpk, _t(d["mu_xi"][k]), _t(d["sig2_xi"][k]),
                        _t(d["mu_b"][k]), _t(d["sig2_b"][k]), tw),
               jl.cost3(pk, d["mu_xi"][k], d["sig2_xi"][k], d["mu_b"][k],
                        d["sig2_b"][k], jw))


@pytest.mark.parametrize("wname", list(WEIGHTS))
def test_cluster_costs_all_clusters_at_once(wname):
    """[Kc, B] responsibilities give each cluster's JAX value."""
    d = _inputs(2)
    jw, tw = _w(wname)
    pk = _t(d["ekhat"]).t()
    got = {
        "cost1": tl.cost1(pk, _t(d["mu_th"], True), _t(d["sig2_th"], True),
                          _t(d["x"], True), tw),
        "cost2": tl.cost2(pk, tw), "cost21": tl.cost21(pk, tw),
        "cost3": tl.cost3(pk, _t(d["mu_xi"]), _t(d["sig2_xi"]),
                          _t(d["mu_b"]), _t(d["sig2_b"]), tw)}
    for k in range(KC):
        p = d["ekhat"][:, k]
        _close(got["cost1"][k], jl.cost1(p, d["mu_th"][k], d["sig2_th"][k],
                                         d["x"], jw))
        _close(got["cost2"][k], jl.cost2(p, jw))
        _close(got["cost21"][k], jl.cost21(p, jw))
        _close(got["cost3"][k], jl.cost3(p, d["mu_xi"][k], d["sig2_xi"][k],
                                         d["mu_b"][k], d["sig2_b"][k], jw))
    assert all(v.shape == (KC,) for v in got.values())


@pytest.mark.parametrize("kc", [1, KC, 10])
@pytest.mark.parametrize("wname", list(WEIGHTS))
def test_vae_cl_loss(kc, wname):
    d = _inputs(3 + kc, kc)
    jw, tw = _w(wname)
    keys = ("ekhat", "mu_xi", "sig2_xi", "mu_b", "sig2_b", "mu_th", "sig2_th")
    want = jl.vae_cl_loss(*(jnp.asarray(d[k]) for k in keys), d["x"], w=jw)
    got = tl.vae_cl_loss(*(_t(d[k], k in ("mu_th", "sig2_th")) for k in keys),
                         _t(d["x"], True), w=tw)
    _close(got, want)


def test_pad_rows_do_not_count():
    """Under the partial weights, rows 4-5 may hold anything."""
    d, e = _inputs(4), _inputs(5)
    for k in ("x", "recon", "mu", "logvar", "ekhat"):
        e[k][:4] = d[k][:4]
    for k in ("mu_xi", "sig2_xi", "mu_b", "sig2_b", "mu_th", "sig2_th"):
        e[k][:, :4] = d[k][:, :4]
    _, tw = _w("partial")
    keys = ("ekhat", "mu_xi", "sig2_xi", "mu_b", "sig2_b", "mu_th", "sig2_th")

    def both(v):
        return (tl.vae_loss(_t(v["recon"], True), _t(v["x"], True),
                            _t(v["mu"]), _t(v["logvar"]), tw),
                tl.vae_cl_loss(*(_t(v[k], k in ("mu_th", "sig2_th"))
                                 for k in keys), _t(v["x"], True), w=tw))

    for a, b in zip(both(d), both(e)):
        _close(a, b)
    # the full batch does see them
    assert float(tl.vae_loss(_t(d["recon"], True), _t(d["x"], True),
                             _t(d["mu"]), _t(d["logvar"]))) != float(
        tl.vae_loss(_t(e["recon"], True), _t(e["x"], True), _t(e["mu"]),
                    _t(e["logvar"])))
    assert np.isfinite(both(d)[1].item())
