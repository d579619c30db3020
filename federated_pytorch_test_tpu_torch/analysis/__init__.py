"""Runtime analysis of the port's steps.

Port of the runtime half of ``federated_pytorch_test_tpu/analysis/``: the
sanitizer (:mod:`.sanitize`, ``--sanitize``).  The JAX package's lint of
its own sources is not ported (it checks the JAX package only).
"""
