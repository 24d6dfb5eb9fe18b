"""MicroNN in PyTorch and CUDA: a port of the JAX package `repro`.

The resident engine (`repro_torch.storage.engine.MicroNN`) runs on an
NVIDIA GPU through three hand-written CUDA kernels (kernels/csrc) and on
the CPU through their plain PyTorch versions. It imports nothing of JAX.
"""
