"""The frozen FLOP count of ``counts.step_flops`` against
``torch.utils.flop_counter.FlopCounterMode`` on the reference model, at
batch 1: the forward, and the backward that trains one block (only its
parameters need gradients)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, spec as speclib
from portbench.reference import resnet

CONFIGS = {c["name"]: speclib._json(f"{speclib.ROOT}/{c['file']}")
           for c in speclib.benchmark()["configs"]}
CASES = [(name, i) for name, cfg in CONFIGS.items()
         for i in range(len(cfg["blocks"]))]


def measured(cfg: dict, block) -> tuple:
    nb = cfg["num_blocks"]
    shapes = resnet.param_shapes(nb, cfg["num_classes"])
    gen = torch.Generator().manual_seed(0)
    trained = set(list(shapes)[block[0]:block[1] + 1])
    params = {n: (torch.randn(s, generator=gen) * 0.05).requires_grad_(n in trained)
              for n, s in shapes.items()}
    stats = resnet.init_stats(nb)
    x = torch.randn(1, 3, 32, 32, generator=gen)
    with FlopCounterMode(display=False) as fwd:
        logits, _ = resnet.forward(params, stats, x, nb, train=True)
    loss = logits.square().sum()
    with FlopCounterMode(display=False) as bwd:
        loss.backward()
    return fwd.get_total_flops(), bwd.get_total_flops()


@pytest.mark.parametrize("config,block", CASES)
def test_step_flops_match_flop_counter(config, block):
    cfg = CONFIGS[config]
    rng = cfg["blocks"][block]
    assert counts.step_flops(cfg["num_blocks"], tuple(rng),
                             cfg["num_classes"]) == measured(cfg, rng)


def test_quant_bound_counts_each_byte_once():
    # B1 on [c, w]: v read (4 B), q written (1 B), c scales written (4 B)
    assert counts.quant_bound("quantize_rows", 2, 256) == (2 * 256 * 5 + 8,
                                                           6 * 512)
    # B2: acc read and out written (4 B each), q read (1 B), scales read
    assert counts.quant_bound("dequant_add", 2, 256) == (2 * 256 * 9 + 8,
                                                         2 * 512)
    nbytes, flops = counts.quant_bound("quantize_rows", 9220, 256)
    assert counts.least_seconds(nbytes, flops) == nbytes / counts.HBM_BYTES_PER_S
