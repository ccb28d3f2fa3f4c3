"""PyTorch + CUDA port of the LVLM inference system, for one NVIDIA H100.

Mirrors ``repro`` (the JAX reference) module for module and imports
nothing of it: ``repro_torch.models.attention`` ports
``repro.models.attention`` and so on. The public surface is
``repro_torch.api.LVLM``. Attention runs through hand-written CUDA
kernels for Hopper (``repro_torch.kernels``) on the card, and through
their plain PyTorch versions on CPU tensors.
"""
