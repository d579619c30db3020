"""PyTorch + CUDA port of ``federated_pytorch_test_tpu``, for one NVIDIA H100.

The JAX package beside this one is the reference: each module here mirrors
one of its modules and is held against it by ``tests/test_torch_*.py``.
This package imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing of the JAX package — so it runs on a machine that has no JAX.

Ported so far: the federated CPC trainer (``train/cpc_engine.py``) with
its L-BFGS, models, data pipeline and the two InfoNCE kernels
(``csrc/infonce.cu``), driven by ``drivers/federated_cpc.py``; and the
classifier consensus round (``train/engine.py``) with the CIFAR-10
pipeline, the classifier models, the algorithms, the robust estimators
over a logical client mesh and krum's Gram kernel (``csrc/gram.cu``),
driven by ``drivers/consensus_multi.py``; and the compressed exchange of
that round (``compress/`` q8/q4 with error feedback) with the fused
quantized collective (``ops/packed_reduce.py``) and its quantize and
dequantize-accumulate kernels (``csrc/quant.cu``); the other classifier
drivers and the VAEs; and the robustness shell of a round
(``train/rounds.py``, ``train/faults.py``, ``population/``) with the
mid-run checkpoint and resume (``utils/checkpoint.py``); the record
stream and its readers (``obs/``), the control plane and restart
supervisor (``control/``), the serving plane (``serve/``) and the soak
campaigns (``campaign/``).
"""
