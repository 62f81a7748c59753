"""PyTorch/CUDA port of the batched kube-scheduler.

A second package beside the JAX reference.  It imports torch and numpy and
nothing of the reference package: every host module it needs is its own copy.
This slice ports the signature fast path with ``residentDrain: false``:
``ops.fastpath.static_eval`` (K1), ``ops.fastpath.sig_scan`` (K2) and
``ops.resident.usage_checksum`` (K3) are CUDA C++ kernels for sm_90a under
``csrc/``, each beside a plain PyTorch version that the CPU path uses.
"""
