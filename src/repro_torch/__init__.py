"""PyTorch and CUDA port of the MT4G topology-discovery system.

``repro_torch.core`` mirrors ``repro.core`` module for module;
``repro_torch.kernels`` holds the kernels written by hand for NVIDIA Hopper
(CUDA C++) with their plain PyTorch versions; ``configs``,
``models``, ``serve`` and ``launch`` port the token-serving path of the
reference's LLM framework for the dense and ssm families.
"""
