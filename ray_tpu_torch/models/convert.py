"""Parameter trees between numpy and the port.

A JAX parameter tree passed through ``np.asarray`` leaf by leaf is a
nested dict of numpy arrays with the JAX package's key names; the port's
models use the same names and layouts, so the tree loads as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch._tree import tree_map


def params_from_numpy(tree, device=None, dtype: torch.dtype | None = None):
    """Nested dict of array-likes -> nested dict of tensors on ``device``
    (``cuda`` unless asked otherwise), cast to ``dtype`` when given."""
    device = resolve_device(device)

    def leaf(a):
        t = torch.from_numpy(np.array(a))  # a writable, contiguous copy
        return t.to(device=device, dtype=dtype)

    return tree_map(leaf, tree)


def params_to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays (on the host;
    bf16 leaves come back as float32, which numpy can hold)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(leaf, tree)
