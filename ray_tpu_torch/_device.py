"""Where the port's entry points run.

They run on the GPU unless the caller asks for the CPU by name, as the
CPU tests do. Without a GPU they raise rather than drift to the CPU: a
number measured there would otherwise pass for a GPU number.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is absent); ``"cpu"`` only
    when asked for; any other value as ``torch.device`` reads it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
