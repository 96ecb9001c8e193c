"""Kernels written by hand for NVIDIA Hopper, with their wrappers.

``pchase_probe``, ``flash_attention``, ``rwkv6_scan`` and ``stream_probe``
(CUDA C++ in ``csrc/``, built by ``_build``) hold the kernels and their
plain PyTorch versions; ``ops`` holds the checked, counted wrappers the
runner and the models call.
"""
from . import ops

__all__ = ["ops"]
