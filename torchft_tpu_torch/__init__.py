"""torchft_tpu_torch: the PyTorch and CUDA port of torchft_tpu.

Per-step fault-tolerant training on NVIDIA GPUs: the same C++ lighthouse and
manager server (the framework-free binaries under ``torchft_tpu/_cpp``)
compute a quorum of healthy replica groups each step; a per-group Manager
reconfigures the replica-axis process group, live-heals recovering groups by
streaming checkpoints from a healthy peer, and gates optimizer commits with a
distributed should-commit vote. Attention runs through hand-written CUDA
kernels for Hopper (``ops/csrc``). The JAX package stays the reference; this
package imports nothing of it.
"""

__version__ = "0.1.0"
