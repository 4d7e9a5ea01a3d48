"""PyTorch/CUDA port of the GAQ system, serving and training (``repro``'s
counterpart).

Module names follow ``repro`` so each counterpart is easy to find. The
package imports ``torch`` and numpy only: nothing of JAX and nothing of
``repro``. Its kernels are CUDA C++ for Hopper (``kernels/csrc``), built
with ``nvcc`` at first use; on CPU tensors every kernel wrapper runs its
plain PyTorch version instead (see ``repro_torch.device`` for the device
rule).
"""
from repro_torch.device import disable_tf32, resolve_device

disable_tf32()

__all__ = ["resolve_device"]
