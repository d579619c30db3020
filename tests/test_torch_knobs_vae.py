"""The throughput knobs on the VAE-CL trainer, held against its plain
loop: the blocks switch between L-BFGS and Adam, and the noise is keyed
on (seed, epoch counter, client, step), so the fused round (whose L-BFGS
blocks read the host in their line search) and the overlaps draw what the
plain loop draws, and end bit for bit where it ends.  K=2 clients, one
minibatch an epoch; the runs of ``test_torch_knobs.py``.
"""

from test_torch_knobs import DATA, assert_same, run

from federated_pytorch_test_tpu_torch.models.vae_cl import AutoEncoderCNNCL
from federated_pytorch_test_tpu_torch.train import algorithms as alg
from federated_pytorch_test_tpu_torch.train.vae_engine import VAECLTrainer


def test_vae_cl_switches_optimizer_per_block_under_every_knob():
    kw = dict(trainer=VAECLTrainer, model=lambda: AutoEncoderCNNCL(K=3, L=4),
              algo=alg.FedAvg, blocks=3, Nepoch=1, Nadmm=2, lambda2=1e-3,
              K=2, data=dict(DATA, K=2, limit_per_client=24))
    a = run(device_data=False, **kw)
    b = run(device_data=True, fused_rounds=True, **kw)
    c = run(device_data=True, overlap_staging=True, overlap_round=True, **kw)
    assert_same(a, b)
    assert_same(a, c)
    assert [b[0].optimizer_for_block(ci) for ci in range(3)] == [
        "lbfgs", "lbfgs", "adam"]
    assert [r["host_dispatches"] for r in b[2]] == [1] * 6
    assert [r["overlap_dispatch_seconds"] > 0 for r in c[2]] == \
        [True, False] * 3
