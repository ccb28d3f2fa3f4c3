"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Each kernel module (``flash_attention``, ``paged_attention``,
``mla_attention``) holds the wrapper, whose ``launches`` attribute counts
its kernel launches, the plain version the wrapper runs on CPU tensors,
and a note naming what of the reference it replaces (a Pallas TPU kernel,
or for ``mla_attention`` the jnp einsums of the absorbed MLA decode). A
``meta`` tensor (the dry run's shape-only stand-ins) takes the plain
version too, which then only carries shapes. ``ops`` adds the reference's
shape checks;
``build.build_all()`` compiles every kernel from ``csrc/`` with nvcc.
``flash_attention`` also holds the flash backward (``flash_attention_bwd``,
``csrc/flash_attention_bwd.cu``), the gradient training runs through; the
decode kernels have none and raise when asked for one.
"""
import torch


def plain_device(t) -> bool:
    """Does a wrapper run its plain version on ``t``? On the CPU and on
    ``meta`` (shapes only); a CUDA tensor launches the kernel or raises."""
    return t.device.type in ("cpu", "meta")


def needs_grad(*tensors) -> bool:
    """Would autograd record a call on these tensors?"""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


_SMS = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (cached): the kernels
    that size their grids to the card read it."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]
