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
driven by ``drivers/consensus_multi.py``.
"""
