"""PyTorch and CUDA port of the MT4G topology-discovery system.

``repro_torch.core`` mirrors ``repro.core`` module for module;
``repro_torch.kernels`` holds the kernels written by hand for NVIDIA Hopper
(CUDA C++) with their plain PyTorch versions; ``configs``,
``models``, ``serve``, ``train``, ``data``, ``checkpoint``, ``ft``,
``sharding`` and ``launch`` port the reference's LLM framework (serving
and training of its six model families, on a ``torch.distributed``
device mesh).
"""
