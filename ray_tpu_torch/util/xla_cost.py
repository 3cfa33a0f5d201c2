"""Cost accounting for a train step, the MFU numerator (port of
``ray_tpu/util/xla_cost.py``; the module keeps the reference's name so a
reader finds its counterpart).

What replaces XLA: the reference lowers and compiles the jitted step and
reads ``cost_analysis()`` of the compiled HLO. Eager PyTorch has no
compiled program to read, so ``step_cost`` runs the step once under
``torch.utils.flop_counter.FlopCounterMode`` and counts the FLOPs of every
op it dispatches that has a FLOP formula: the matrix products, forward,
backward and what remat recomputes in the backward (XLA's count includes
recomputation too), and the flash-attention kernels through the formulas
``ops/flash_attention.py`` registers. Elementwise ops, norms and the fused
norm and GELU kernels count 0 on either path (XLA counts elementwise ops,
so its count is a little higher). There is no byte count: the mode sees
FLOPs only, so ``bytes_accessed`` and the roofline keys are None.

The call runs on copies of the step's tensor arguments, so the caller's
state is untouched (the port's train step updates its state in place);
the copies take the state's memory once more while the call runs. It is
one more call of the step: its kernel launches count with the run's.
FlopCounterMode is a dispatch mode of the thread that enters it (the
autograd engine carries it to its device threads for the backward), so
call ``step_cost`` on the thread that runs the step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ray_tpu_torch._device import device_name, device_spec, peak_flops_per_chip


def stub(reason: str) -> Dict[str, Any]:
    """The no-cost shape: ``available=False`` so nothing downstream takes
    it for a cost."""
    return {"available": False, "reason": reason}


def _copy(tree):
    """The nested dicts, lists and tuples of ``tree`` with every tensor
    cloned (other leaves shared)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy(v) for v in tree)
    return tree


def _first_device(tree) -> Optional[torch.device]:
    if isinstance(tree, torch.Tensor):
        return tree.device
    items = (tree.values() if isinstance(tree, dict)
             else tree if isinstance(tree, (list, tuple)) else ())
    for v in items:
        dev = _first_device(v)
        if dev is not None:
            return dev
    return None


def device_kind_of(device: Optional[torch.device] = None) -> str:
    """The name the peak table is looked up by: ``torch.cuda.
    get_device_name`` of a CUDA device (of the current one for None, once
    CUDA is initialised in this process), else the device type."""
    if device is None:
        device = torch.device("cuda" if torch.cuda.is_initialized()
                              else "cpu")
    return device_name(torch.device(device))


def step_cost(step_fn: Any, *args: Any,
              device_kind: Optional[str] = None,
              **kwargs: Any) -> Dict[str, Any]:
    """FLOPs of one call of ``step_fn(*args, **kwargs)``, counted by
    FlopCounterMode over a call on copies of the arguments (see the
    module docstring). Returns ``{available, flops, flops_by_op,
    bytes_accessed, intensity_flops_per_byte, device_kind, peak_flops,
    peak_hbm_bytes_per_s, ridge_flops_per_byte, roofline, roofline_frac,
    memory}``; a stub when the call counted no FLOP."""
    from torch.utils.flop_counter import FlopCounterMode

    kind = (device_kind if device_kind is not None
            else device_kind_of(_first_device((args, kwargs))))
    spec = device_spec(kind)
    a, kw = _copy(args), _copy(kwargs)
    with FlopCounterMode(display=False) as counter:
        step_fn(*a, **kw)
    del a, kw
    flops = float(counter.get_total_flops())
    if flops <= 0:
        return stub("the call dispatched no op with a FLOP formula")
    by_op = {str(op): int(n) for op, n in
             counter.get_flop_counts().get("Global", {}).items()}
    return {
        "available": True,
        "flops": flops,
        "flops_by_op": by_op,
        "bytes_accessed": None,
        "intensity_flops_per_byte": None,
        "device_kind": kind,
        "peak_flops": spec["bf16_flops"],
        "peak_hbm_bytes_per_s": spec["hbm_bytes_s"],
        "ridge_flops_per_byte": spec["bf16_flops"] / spec["hbm_bytes_s"],
        "roofline": None,
        "roofline_frac": None,
        "memory": {},
    }


def mfu_percent(flops_per_step: float, step_seconds: float,
                device_kind: Optional[str] = None,
                n_devices: int = 1) -> float:
    """Model-FLOPs utilization: FLOPs per step over measured step seconds,
    against the device peak (one device's dense bf16 peak times the device
    count) -- the same denominator ``scripts/measure.py`` uses, from
    ``_device``'s table."""
    if step_seconds <= 0 or flops_per_step <= 0:
        return 0.0
    kind = device_kind if device_kind is not None else device_kind_of()
    peak = peak_flops_per_chip(kind) * max(1, n_devices)
    return flops_per_step / step_seconds / peak * 100.0
