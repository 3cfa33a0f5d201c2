"""ray_tpu_torch -- the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper GPUs.

It mirrors ``ray_tpu``'s module paths (``ray_tpu/ops/fused_norm.py`` ->
``ray_tpu_torch/ops/fused_norm.py``) so each file can be held against its
counterpart. It imports ``torch`` and never ``jax``, and nothing from
``ray_tpu``: what it needs from there it carries its own copy of.

Importing the package builds and launches nothing. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; the CUDA kernels are
built from ``ops/csrc/`` at first use.
"""

from ray_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
