"""Where the port's entry points run, and the peak rates of the cards
they run on.

They run on the GPU unless the caller asks for the CPU by name, as the
CPU tests do. Without a GPU they raise rather than drift to the CPU: a
number measured there would otherwise pass for a GPU number. The peak
table is the MFU denominator of ``util/xla_cost`` (the session's gauge)
and of ``scripts/measure``.
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


# Published peaks by substring of torch.cuda.get_device_name(), lowercased,
# first match wins: dense bf16 tensor-core FLOP/s, fp32 FLOP/s outside the
# tensor cores, and device-memory bytes/s (NVIDIA's H100 data sheet, at the
# card's full power limit). "cpu" is nominal, so the harness runs in tests.
DEVICE_SPECS = {
    "h100 sxm": {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes_s": 3.35e12},
    "h100 80gb hbm3": {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes_s": 3.35e12},
    "h100 pcie": {"bf16_flops": 756e12, "fp32_flops": 51e12, "hbm_bytes_s": 2.0e12},
    "cpu": {"bf16_flops": 0.5e12, "fp32_flops": 0.5e12, "hbm_bytes_s": 0.05e12},
}


def device_spec(device_name: str) -> dict[str, float]:
    """Peak rates of the device named ``device_name``; raises for a device
    the table does not know rather than guess its peak."""
    name = device_name.lower()
    for key, spec in DEVICE_SPECS.items():
        if key in name:
            return spec
    raise ValueError(f"no peak rates known for device {device_name!r}; "
                     "add it to DEVICE_SPECS")


def peak_flops_per_chip(device_name: str) -> float:
    """Dense bf16 peak FLOP/s of one device (the MFU denominator)."""
    return device_spec(device_name)["bf16_flops"]


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type
