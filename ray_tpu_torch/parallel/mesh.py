"""Device meshes with named parallelism axes (port of
``ray_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group (``parallel/distributed.py:initialize`` brings it
up), one device a rank, with the six axis names of ``AXIS_ORDER`` as its
``mesh_dim_names``. Size-1 axes are kept, so model and step code index the
mesh by name whatever its shape, as in the JAX package:

    pp    pipeline stages        (outermost)
    dp    pure data parallelism
    fsdp  data parallelism with sharded params/optimizer (ZeRO-3 style)
    ep    expert parallelism for MoE
    sp    sequence/context parallelism
    tp    tensor (Megatron-style) parallelism, innermost

What differs from the JAX module, and why:

* ``MeshConfig.devices`` holds global ranks, not ``jax.Device``s: a rank
  is one device.
* Ranks are laid out in rank order (a reshape); ``jax.make_mesh`` may
  reorder TPU devices by their physical topology, and lays CPU devices out
  in the same order as here.
* Ranks carry no slice index, so ``build_hybrid_mesh`` always takes the
  JAX module's path for hosts without one: the ranks split evenly, in
  order, into ``dcn_dp * dcn_pp`` synthetic slices.
* Only ``dp``, ``fsdp`` and ``ep`` (the MoE model's experts) may exceed 1
  in a train step (``train/train_step.py``); a mesh of another shape may
  still be built.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch._device import resolve_device

# Outermost -> innermost, as in the JAX package.
AXIS_ORDER: tuple[str, ...] = ("pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape. Product of all axes must equal device count.

    ``-1`` on at most one axis means "absorb all remaining devices"
    (same convention as a reshape wildcard).
    """

    pp: int = 1
    dp: int = 1
    fsdp: int = -1
    ep: int = 1
    sp: int = 1
    tp: int = 1
    # Global ranks of the default process group, one device each (for
    # subsetting / tests); None = every rank.
    devices: Sequence[int] | None = None

    def axis_sizes(self, n_devices: int) -> dict[str, int]:
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"At most one axis may be -1, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[wild[0]] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"Mesh {sizes} needs {math.prod(sizes.values())} devices, "
                f"have {n_devices}"
            )
        return sizes


def local_device_count() -> int:
    return torch.cuda.device_count()


def auto_mesh_config(n_devices: int | None = None) -> MeshConfig:
    """Default config: pure fsdp (ZeRO-3 data parallelism) over every device.

    This is the safest high-performance default for dense LLM training at
    single-slice scale; callers opt into tp/sp/pp explicitly.
    """
    return MeshConfig(fsdp=n_devices if n_devices is not None else -1)


def _world_ranks() -> list[int]:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call ray_tpu_torch.parallel.distributed."
            "initialize before building a mesh")
    return list(range(dist.get_world_size()))


def _device_mesh(ranks: np.ndarray, device: torch.device) -> DeviceMesh:
    """A ``DeviceMesh`` of ``device``'s type over ``ranks`` (shaped as
    AXIS_ORDER). A CUDA mesh needs the NCCL group that ``initialize``
    brings up for ``cuda``; it does not fall back to another backend."""
    _world_ranks()
    if device.type == "cuda":
        if dist.get_backend() != "nccl":
            raise RuntimeError(f"a cuda mesh needs an nccl process group, "
                               f"got {dist.get_backend()!r}")
        if device.index is not None:
            torch.cuda.set_device(device.index)
    return DeviceMesh(device.type, torch.as_tensor(ranks, dtype=torch.int64),
                      mesh_dim_names=AXIS_ORDER)


def build_mesh(config: MeshConfig | None = None, *, device=None) -> DeviceMesh:
    """A ``DeviceMesh`` with the standard axis names over ``config.devices``
    (every rank of the default group when None), on ``cuda`` unless
    ``device`` says otherwise. Every rank of the group calls it."""
    device = resolve_device(device)
    config = config or auto_mesh_config()
    ranks = (list(config.devices) if config.devices is not None
             else _world_ranks())
    sizes = config.axis_sizes(len(ranks))
    return _device_mesh(
        np.array(ranks).reshape([sizes[a] for a in AXIS_ORDER]), device)


def _hybrid_ranks(
    per_slice: MeshConfig | None,
    *,
    dcn_dp: int | None,
    dcn_pp: int,
    ranks: Sequence[int],
) -> np.ndarray:
    """The rank layout of ``build_hybrid_mesh``: ``ranks`` split in order
    into ``dcn_dp * dcn_pp`` synthetic slices, each shaped by
    ``per_slice``, the DCN dims merged into ``pp`` and ``dp``."""
    ranks = list(ranks)
    n_slices = (dcn_dp if dcn_dp is not None else 1) * dcn_pp
    if len(ranks) % n_slices:
        raise ValueError(
            f"{len(ranks)} devices not divisible into "
            f"{n_slices} synthetic slices")
    dcn_dp = n_slices // dcn_pp
    cfg = per_slice or MeshConfig(fsdp=-1)
    sizes = cfg.axis_sizes(len(ranks) // n_slices)
    # [dcn_pp, dcn_dp, pp, dp, fsdp, ep, sp, tp] -- each slice keeps its
    # ranks contiguous over the inner (ICI) dims.
    stacked = np.array(ranks).reshape(
        dcn_pp, dcn_dp, *[sizes[a] for a in AXIS_ORDER])
    # Merge DCN dims into their ICI counterparts: pp-total outermost.
    stacked = np.moveaxis(stacked, 2, 1)  # [dcn_pp, pp, dcn_dp, dp, ...]
    return stacked.reshape(
        dcn_pp * sizes["pp"], dcn_dp * sizes["dp"], sizes["fsdp"],
        sizes["ep"], sizes["sp"], sizes["tp"])


def build_hybrid_mesh(
    per_slice: MeshConfig | None = None,
    *,
    dcn_dp: int | None = None,
    dcn_pp: int = 1,
    devices: Sequence[int] | None = None,
    device=None,
) -> DeviceMesh:
    """Multi-slice mesh: only DCN-tolerant axes across slices.

    Put pure data parallelism (``dcn_dp``: gradient all-reduce once per
    step) and/or pipeline stages (``dcn_pp``) across slices and keep
    tp/sp/fsdp collectives inside one. ``devices`` (global ranks; every
    rank when None) split in order into ``dcn_dp * dcn_pp`` slices;
    ``per_slice`` shapes the axes of one slice; the result is a standard
    AXIS_ORDER mesh whose ``dp``/``pp`` sizes are the DCN-times-slice
    products.
    """
    device = resolve_device(device)
    ranks = list(devices) if devices is not None else _world_ranks()
    return _device_mesh(_hybrid_ranks(per_slice, dcn_dp=dcn_dp, dcn_pp=dcn_pp,
                                       ranks=ranks), device)


def single_device_mesh(*, device=None) -> DeviceMesh:
    """1-device mesh (all axes size 1, rank 0) -- lets model code be
    mesh-agnostic."""
    return build_mesh(MeshConfig(fsdp=1, devices=[0]), device=device)
