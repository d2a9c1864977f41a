"""Shisha on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

The paper's loop (build a CNN, measure each layer on the device, seed and
tune a stage split with Shisha, run it as a microbatched pipeline, rebalance
a straggler) on one card, every convolution through a hand-written sm_90a
kernel.  The package imports ``torch`` and never ``jax``, and nothing of the
JAX package: the framework-free scheduling code it needs is copied into
``repro_torch.core``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU each kernel wrapper runs its plain PyTorch
version.
"""
