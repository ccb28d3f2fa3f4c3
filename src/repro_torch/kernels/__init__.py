"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Each kernel module (``flash_attention``, ``paged_attention``) holds the
wrapper, whose ``launches`` attribute counts its kernel launches, the
plain version the wrapper runs on CPU tensors, and a note naming the
Pallas TPU kernel it replaces. ``ops`` adds the reference's shape checks;
``build.build_all()`` compiles every kernel from ``csrc/`` with nvcc.
"""
