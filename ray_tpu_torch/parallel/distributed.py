"""Process-group bootstrap (port of ``ray_tpu/parallel/distributed.py``).

Each process is one rank with one device. ``initialize`` joins the ranks
into the default ``torch.distributed`` process group -- NCCL on ``cuda``,
gloo when the caller asks for the CPU -- over a TCP rendezvous at the
coordinator address; ``parallel/mesh.py`` then lays a ``DeviceMesh`` over
that group.

What differs from the JAX module, and why:

* The coordinator address is the caller's: ``publish_coordinator``,
  ``wait_coordinator`` and ``clear_group`` publish and read it through
  the cluster KV, which the port does not have yet (ROADMAP A4).
* One process alone still gets a group (a one-rank group on an in-memory
  store), where ``jax.distributed.initialize`` has nothing to do: a
  ``DeviceMesh`` needs a group.
"""

from __future__ import annotations

import datetime
import socket
from typing import Optional

import torch
import torch.distributed as dist

from ray_tpu_torch._device import resolve_device


def host_ip() -> str:
    """Best-effort routable IP of this host (falls back to localhost)."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("8.8.8.8", 80))  # no packets sent; picks the route
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return "127.0.0.1"


def free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def initialize(
    group: str,
    rank: int,
    world_size: int,
    *,
    device=None,
    coordinator_address: Optional[str] = None,
    timeout: float = 120.0,
) -> None:
    """Join ``world_size`` ranks into the default process group.

    ``device`` is ``cuda`` unless the caller asks for the CPU: on ``cuda``
    the rank's device is set with an index (``device``'s, else ``rank``
    modulo the local device count) and the group is NCCL, bound to that
    device; on the CPU the group is gloo. Without a GPU ``cuda`` raises.
    ``coordinator_address`` ("host:port") is rank 0's TCP rendezvous; with
    ``world_size == 1`` and no address the one rank gets a group on an
    in-memory store. ``group`` names the group in errors.
    """
    device = resolve_device(device)
    kw = {}
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else rank % torch.cuda.device_count())
        torch.cuda.set_device(index)
        kw["device_id"] = torch.device("cuda", index)
    backend = "nccl" if device.type == "cuda" else "gloo"
    limit = datetime.timedelta(seconds=timeout)
    if world_size == 1 and coordinator_address is None:
        if rank != 0:
            raise ValueError(f"group {group!r}: rank {rank} of a world of 1")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=limit, **kw)
        return
    if coordinator_address is None:
        raise ValueError(
            f"group {group!r}: pass coordinator_address ('host:port' of rank "
            "0); the cluster-KV rendezvous is not ported (ROADMAP A4)")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            rank=rank, world_size=world_size, timeout=limit,
                            **kw)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
