"""PyTorch/CUDA port of regennet_tpu for NVIDIA Hopper (H100).

The package mirrors the JAX package's module paths (`models/cmdm.py` for
`regennet_tpu/models/cmdm.py`, and so on) and imports nothing of it: the
JAX package is the reference the tests hold this port against. Every
Pallas kernel on a ported path becomes a hand-written CUDA kernel under
`csrc/`, built with nvcc at first use; each kernel wrapper runs the
kernel's plain PyTorch version only for tensors that lie on the CPU.

Entry points run on the GPU unless the caller asks for the CPU
(`device.py`).
"""
