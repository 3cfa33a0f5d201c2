"""Checkpoints (port of ``ray_tpu/train/checkpoint.py``): the
``Checkpoint`` artifact, and sharded train-state checkpoints
(``save_sharded`` / ``load_sharded``).

``Checkpoint`` is one artifact interconvertible between dict, directory
and object-ref forms (reference: ``python/ray/air/checkpoint.py:60``), so
the same object flows worker -> trainer -> user. The object-ref form
lives in the port's object store (``ray_tpu_torch.put``). A dict holds its
values as given: the port's train step updates its state in place, so a
loop that checkpoints a live state passes a copy of its tensors, where the
JAX package's arrays are immutable.

Sharded checkpoints:

Every rank writes only the shards it holds -- one ``.npy`` per unique
shard, ``leaf_{i}.{starts-stops}.npy``, exactly once across ranks (the
lowest rank of each replica group writes it) -- and rank 0 writes a
manifest mapping each leaf's shards to files. No leaf is gathered whole.
Restoring assembles each rank's region straight from the shard files
(mmap'd), onto any mesh and layout: resharding on load. The shard files
are the JAX package's, name for name and byte for byte for fp32 leaves.

What differs from the JAX module, and why:

* The manifest is JSON (``manifest.json``: each leaf's key path, shape,
  dtype and shards, or its inline value), where JAX pickles a jax
  treedef the port cannot read; so the port does not load a checkpoint
  the JAX package wrote, and the JAX package does not load the port's.
* numpy has no bfloat16, so a bf16 leaf goes to disk as its ``uint16``
  bits, with ``bfloat16`` named in the manifest.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch._tree import is_dtensor

_MANIFEST = "manifest.json"


class Checkpoint:
    """Exactly one of ``data`` (dict) / ``directory`` / ``ref`` is set."""

    def __init__(self, data: Optional[dict] = None,
                 directory: Optional[str] = None, ref=None):
        if sum(x is not None for x in (data, directory, ref)) != 1:
            raise ValueError("provide exactly one of data/directory/ref")
        self._data = data
        self._dir = directory
        self._ref = ref

    # -- constructors -----------------------------------------------------

    @classmethod
    def from_dict(cls, data: dict) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise ValueError(f"not a directory: {path}")
        return cls(directory=path)

    @classmethod
    def from_object_ref(cls, ref) -> "Checkpoint":
        return cls(ref=ref)

    # -- conversions ------------------------------------------------------

    def to_dict(self) -> dict:
        if self._data is not None:
            return dict(self._data)
        if self._ref is not None:
            return Checkpoint._materialize(self._ref).to_dict()
        out = {}
        for name in os.listdir(self._dir):
            p = os.path.join(self._dir, name)
            if name.endswith(".pkl"):
                with open(p, "rb") as f:
                    out[name[:-4]] = pickle.load(f)
            elif name.endswith(".npy"):
                out[name[:-4]] = np.load(p, allow_pickle=False)
        return out

    def to_directory(self, path: Optional[str] = None) -> str:
        """One ``.npy`` per numpy value, one ``.pkl`` per other value (a
        tensor pickles with its device)."""
        path = path or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        os.makedirs(path, exist_ok=True)
        if self._dir is not None:
            if os.path.abspath(self._dir) != os.path.abspath(path):
                shutil.copytree(self._dir, path, dirs_exist_ok=True)
            return path
        data = self.to_dict()
        for k, v in data.items():
            if isinstance(v, np.ndarray):
                np.save(os.path.join(path, k + ".npy"), v)
            else:
                with open(os.path.join(path, k + ".pkl"), "wb") as f:
                    pickle.dump(v, f)
        return path

    def to_object_ref(self):
        if self._ref is not None:
            return self._ref
        import ray_tpu_torch

        return ray_tpu_torch.put(self)

    @staticmethod
    def _materialize(ref) -> "Checkpoint":
        import ray_tpu_torch

        value = ray_tpu_torch.get(ref)
        if isinstance(value, Checkpoint):
            return value
        return Checkpoint.from_dict(value)

    def __reduce__(self):
        # Ship directory checkpoints by value (the dir may be node-local).
        if self._dir is not None:
            return (Checkpoint.from_dict, (self.to_dict(),))
        if self._data is not None:
            return (Checkpoint.from_dict, (self._data,))
        return (Checkpoint.from_object_ref, (self._ref,))


def _flatten(tree, path=()) -> list:
    """(key path, leaf) pairs in sorted-key order -- the order of
    ``jax.tree.leaves`` over the same dicts, so leaf i is JAX's leaf i."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], path + (k,))]
    return [(path, tree)]


def _unflatten(pairs) -> Any:
    if len(pairs) == 1 and pairs[0][0] == ():
        return pairs[0][1]
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _at(tree, path):
    """The subtree of ``tree`` at ``path``, or the first non-dict on the
    way (a sharding, or None, given for a whole subtree)."""
    for k in path:
        if not isinstance(tree, dict):
            return tree
        tree = tree[k]
    return tree


def _shard_bounds(shape, placements, mesh_shape, coord) -> tuple:
    """(starts, stops) of the block of a tensor of ``shape`` that the rank
    at mesh coordinate ``coord`` holds under DTensor ``placements``: each
    ``Shard(d)`` splits dim d's current range in ``torch.chunk``'s way,
    by the mesh dims in mesh order."""
    starts, stops = [0] * len(shape), list(shape)
    for p, size, c in zip(placements, mesh_shape, coord):
        if not p.is_shard():
            continue
        d = p.dim
        chunk = -(-(stops[d] - starts[d]) // size)
        lo = min(starts[d] + c * chunk, stops[d])
        starts[d], stops[d] = lo, min(lo + chunk, stops[d])
    return tuple(starts), tuple(stops)


def _shard_key(starts, stops) -> str:
    if not starts:
        return "full"
    return "_".join(f"{a}-{b}" for a, b in zip(starts, stops))


def _atomic_save(path: str, arr: np.ndarray) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.save(f, arr)
    os.replace(tmp, path)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _disk_dtype(dtype: str) -> np.dtype:
    return np.dtype(np.uint16 if dtype == "bfloat16" else dtype)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def save_sharded(state: Any, path: str) -> None:
    """Write a tree of (possibly DTensor) tensors under ``path``.

    Every rank calls this with the same path on shared storage; each
    writes only its shards (exactly once per unique shard across
    replicas; a plain tensor is rank 0's), rank 0 writes the manifest,
    and every rank then waits at a barrier. Python scalars (the step) go
    into the manifest inline.
    """
    os.makedirs(path, exist_ok=True)
    rank = _rank()
    manifest_leaves = []
    for i, (key_path, leaf) in enumerate(_flatten(state)):
        if not isinstance(leaf, torch.Tensor):
            # Small host-side values (python/np scalars): inline.
            value = leaf.item() if isinstance(leaf, np.generic) else leaf
            manifest_leaves.append({"path": list(key_path), "inline": value})
            continue
        shape = tuple(leaf.shape)
        groups: dict = {}  # key -> (starts, stops, [ranks])
        if is_dtensor(leaf):
            ranks = leaf.device_mesh.mesh.numpy()
            for coord in np.ndindex(ranks.shape):
                starts, stops = _shard_bounds(shape, leaf.placements,
                                             ranks.shape, coord)
                groups.setdefault(_shard_key(starts, stops),
                                  (starts, stops, []))[2].append(
                                      int(ranks[coord]))
            local = leaf.to_local()
        else:
            starts, stops = (0,) * len(shape), shape
            groups[_shard_key(starts, stops)] = (starts, stops, [0])
            local = leaf
        shards = []
        for key, (starts, stops, owners) in sorted(groups.items()):
            fname = f"leaf_{i}.{key}.npy"
            shards.append([list(starts), list(stops), fname])
            if min(owners) == rank:  # exactly-once across replicas/ranks
                _atomic_save(os.path.join(path, fname), _to_numpy(local))
        manifest_leaves.append({"path": list(key_path), "shape": list(shape),
                                "dtype": _dtype_name(leaf.dtype),
                                "shards": shards})
    if rank == 0:
        tmp = os.path.join(path, f"{_MANIFEST}.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump({"leaves": manifest_leaves}, f)
        os.replace(tmp, os.path.join(path, _MANIFEST))
    if dist.is_initialized():
        dist.barrier()


def _load_region(path: str, info: dict, starts, stops) -> np.ndarray:
    """Assemble the region [starts, stops) of a saved leaf from its shard
    files (mmap'd: only the bytes actually needed are read)."""
    dtype = _disk_dtype(info["dtype"])
    # Fast path: the region is exactly one saved shard.
    for s_starts, s_stops, fname in info["shards"]:
        if tuple(s_starts) == tuple(starts) and tuple(s_stops) == tuple(stops):
            return np.load(os.path.join(path, fname))
    out = np.empty([b - a for a, b in zip(starts, stops)], dtype)
    for s_starts, s_stops, fname in info["shards"]:
        lo = [max(a, c) for a, c in zip(starts, s_starts)]
        hi = [min(b, d) for b, d in zip(stops, s_stops)]
        if any(l >= h for l, h in zip(lo, hi)):
            continue
        src = np.load(os.path.join(path, fname), mmap_mode="r")
        src_sl = tuple(
            slice(l - c, h - c) for l, h, c in zip(lo, hi, s_starts)
        )
        dst_sl = tuple(
            slice(l - a, h - a) for l, h, a in zip(lo, hi, starts)
        )
        out[dst_sl] = src[src_sl]
    return out


def load_sharded(path: str, shardings: Any = None) -> Any:
    """Restore a tree saved by ``save_sharded``.

    With ``shardings`` (a tree of ``parallel.sharding.NamedSharding`` over
    the saved tree's key paths; None for a leaf or subtree to load whole),
    each rank assembles its region of each leaf straight from the shard
    files, on its mesh's device -- the saved layout may differ from the
    target one (resharding on load) -- and gets DTensors. Without
    shardings, returns full tensors on the CPU.
    """
    from torch.distributed.tensor import DTensor

    with open(os.path.join(path, _MANIFEST)) as f:
        infos = json.load(f)["leaves"]
    pairs = []
    for info in infos:
        key_path = tuple(info["path"])
        if "inline" in info:
            pairs.append((key_path, info["inline"]))
            continue
        shape = tuple(info["shape"])
        sh = _at(shardings, key_path) if shardings is not None else None
        if sh is None:
            full = _load_region(path, info, (0,) * len(shape), shape)
            pairs.append((key_path, _from_numpy(full, info["dtype"])))
            continue
        mesh = sh.mesh
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError(f"rank {_rank()} is not in the target mesh")
        starts, stops = _shard_bounds(shape, sh.placements, mesh.shape, coord)
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device("cpu"))
        local = _from_numpy(_load_region(path, info, starts, stops),
                            info["dtype"]).to(device)
        pairs.append((key_path, DTensor.from_local(
            local, mesh, sh.placements, run_check=False,
            shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())))
    return _unflatten(pairs)
