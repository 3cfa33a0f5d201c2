"""GPT-2 throughput-measurement harness (port of ``ray_tpu/scripts/measure.py``).

One definition of the timed-step protocol (warmup, a device sync, timed
steps, tok/s and MFU accounting) and the per-device peak table that MFU
is taken against.
"""

from __future__ import annotations

import time

import torch

from ray_tpu_torch._device import resolve_device

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


# bench.py's "fused" GPT-2 config (ray_tpu/bench.py:81) with dense attention:
# the configuration this slice of the port drives.
FUSED_DENSE_FLAGS = dict(remat="dots", scan_layers=False, use_flash=False,
                         logits_dtype=torch.bfloat16, ce_vocab_chunks=3,
                         fused_norm=True)


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_gpt2(cfg, batch: int, *, steps: int = 20, warmup: int = 3,
                 device=None) -> dict:  # step-timed
    """Timed GPT-2 train-step loop -> measurement dict.

    Initialises the state from seed 0 and a fixed batch from seed 1, runs
    ``warmup`` steps, syncs the device (``.item()`` of the loss, then
    ``torch.cuda.synchronize``), then times ``steps`` steps and syncs again.

    Returns {tok_s, mfu, ms_step, loss, losses, dt, steps, warmup, batch,
    device}; ``losses`` holds every step's loss, warmup included, and
    ``mfu`` is taken against the device's dense bf16 peak.
    """
    from ray_tpu_torch.models.gpt2 import (
        gpt2_flops_per_token,
        gpt2_init,
        gpt2_loss,
    )
    from ray_tpu_torch.train.train_step import make_init_fn, make_train_step

    device = resolve_device(device)
    warmup = max(warmup, 1)  # >=1: the post-warmup sync reads metrics
    init_fn = make_init_fn(lambda g: gpt2_init(g, cfg, device=device))
    state = init_fn(torch.Generator(device=device).manual_seed(0))
    step_fn = make_train_step(lambda p, b: gpt2_loss(p, b, cfg))
    tokens = torch.randint(
        0, cfg.vocab_size, (batch, cfg.seq_len + 1), device=device,
        generator=torch.Generator(device=device).manual_seed(1))
    batch_data = {"tokens": tokens}
    losses = []
    for _ in range(warmup):
        state, metrics = step_fn(state, batch_data)
        losses.append(metrics["loss"])
    losses[-1].item()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, batch_data)
        losses.append(metrics["loss"])
    loss = metrics["loss"].item()
    _sync(device)
    dt = time.perf_counter() - t0
    tok_s = batch * cfg.seq_len * steps / dt
    name = device_name(device)
    mfu = tok_s * gpt2_flops_per_token(cfg) / peak_flops_per_chip(name) * 100
    return {
        "tok_s": tok_s,
        "mfu": mfu,
        "ms_step": dt / steps * 1000,
        "loss": loss,
        "losses": [float(x) for x in losses],
        "dt": dt,
        "steps": steps,
        "warmup": warmup,
        "batch": batch,
        "device": name,
    }
