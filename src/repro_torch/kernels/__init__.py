"""Kernels of the port, written by hand for Hopper.

Each kernel has a CUDA source under ``csrc/``, a wrapper module that
launches it for CUDA tensors and counts its launches, a plain PyTorch
version in ref.py (used for CPU tensors and as the yardstick on the card),
and a public entry point in ops.py. The flash kernel also has a
hand-written gradient (``csrc/flash_attention_bwd.cu``, through
``flash_attention.FlashAttention``); the other wrappers refuse a gradient.
"""
from repro_torch.kernels import ops, ref  # noqa: F401
