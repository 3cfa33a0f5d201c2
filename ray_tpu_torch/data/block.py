"""Blocks: the unit of distributed data (port of ``ray_tpu/data/block.py``;
reference: ``python/ray/data/block.py``).

Three physical layouts, mirroring the reference's simple vs Arrow blocks:
  * list block -- ``list`` of rows (arbitrary Python objects / dicts);
  * columnar block -- ``dict[str, np.ndarray]`` (tensor-friendly);
  * arrow block -- ``pyarrow.Table`` (the reference's default block type).

``BlockAccessor``-style helpers are plain functions here. pyarrow and
pandas are imported only where a block or a batch format needs them: a
process that never meets an arrow block or a pandas batch runs without
either installed.
"""

from __future__ import annotations

import sys
from typing import Any, Iterable, List, Union

import numpy as np

Block = Union[List[Any], dict, "pyarrow.Table"]


def is_arrow(block: Block) -> bool:
    # Cheap check without importing pyarrow for non-arrow blocks.
    return type(block).__module__.startswith("pyarrow")


def is_columnar(block: Block) -> bool:
    return isinstance(block, dict)


def num_rows(block: Block) -> int:
    if is_arrow(block):
        return block.num_rows
    if is_columnar(block):
        if not block:
            return 0
        return len(next(iter(block.values())))
    return len(block)


def size_bytes(block: Block) -> int:
    """Approximate in-memory bytes of a block (exact for arrow/columnar
    via nbytes; list blocks are sampled -- the stats plane wants
    distribution shape, not an accountant)."""
    if is_arrow(block):
        return int(block.nbytes)
    if is_columnar(block):
        return int(sum(getattr(v, "nbytes", 0) for v in block.values()))
    n = len(block)
    if n == 0:
        return 0
    k = min(n, 64)
    sampled = sum(sys.getsizeof(r) for r in block[:k])
    return int(sampled * n / k)


def slice_block(block: Block, start: int, end: int) -> Block:
    if is_arrow(block):
        return block.slice(start, end - start)
    if is_columnar(block):
        return {k: v[start:end] for k, v in block.items()}
    return block[start:end]


def split_cuts(block: Block, target_bytes: int) -> List[int]:
    """Row boundaries of ``split_block``'s pieces: ``[0, ..., n]``, just
    ``[0, n]`` when the block stays whole."""
    n = num_rows(block)
    total = size_bytes(block)
    if target_bytes <= 0 or n <= 1 or total <= target_bytes:
        return [0, n]
    parts = min(n, -(-total // target_bytes))  # ceil division
    cuts = [round(i * n / parts) for i in range(parts + 1)]
    return [c for i, c in enumerate(cuts) if i == 0 or c > cuts[i - 1]]


def split_block(block: Block, target_bytes: int) -> List[Block]:
    """Dynamic block splitting: row-range slices of a block whose
    estimated size exceeds ``target_bytes``, each at most ~target-sized.
    Slices are views (arrow ``slice`` / numpy basic indexing), so the
    split itself copies nothing. A block at or under target (or with a
    single row) passes through unsplit."""
    cuts = split_cuts(block, target_bytes)
    if len(cuts) == 2:
        return [block]
    return [slice_block(block, a, b) for a, b in zip(cuts, cuts[1:])]


def concat_blocks(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if num_rows(b) > 0]
    if not blocks:
        return []
    if is_arrow(blocks[0]):
        import pyarrow as pa

        return pa.concat_tables(blocks)
    if is_columnar(blocks[0]):
        keys = blocks[0].keys()
        return {k: np.concatenate([b[k] for b in blocks]) for k in keys}
    out: list = []
    for b in blocks:
        out.extend(b)
    return out


def rows_of(block: Block) -> Iterable[Any]:
    if is_arrow(block):
        yield from block.to_pylist()
    elif is_columnar(block):
        keys = list(block.keys())
        for i in range(num_rows(block)):
            yield {k: block[k][i] for k in keys}
    else:
        yield from block


def from_rows(rows: List[Any], like: Block) -> Block:
    """Rebuild a block from rows, keeping the input layout when possible."""
    if is_arrow(like) and rows and isinstance(rows[0], dict):
        import pyarrow as pa

        return pa.Table.from_pylist(rows)
    if is_columnar(like) and rows and isinstance(rows[0], dict):
        keys = rows[0].keys()
        return {k: np.asarray([r[k] for r in rows]) for k in keys}
    return list(rows)


def to_batch(block: Block, batch_format: str):
    """Materialize a block in the requested batch format
    (``iter_batches(batch_format=...)`` parity: numpy / pandas / pyarrow
    / default)."""
    if batch_format in ("default", "native"):
        return block
    if batch_format == "numpy":
        if is_arrow(block):
            return {
                name: block.column(name).to_numpy(zero_copy_only=False)
                for name in block.column_names
            }
        if is_columnar(block):
            return block
        if block and isinstance(block[0], dict):
            keys = block[0].keys()
            return {k: np.asarray([r[k] for r in block]) for k in keys}
        return np.asarray(block)
    if batch_format == "pandas":
        import pandas as pd

        if is_arrow(block):
            return block.to_pandas()
        if is_columnar(block):
            return pd.DataFrame({k: list(v) for k, v in block.items()})
        if block and isinstance(block[0], dict):
            return pd.DataFrame(block)
        return pd.DataFrame({"value": block})
    if batch_format == "pyarrow":
        import pyarrow as pa

        if is_arrow(block):
            return block
        if is_columnar(block):
            return pa.table({k: np.asarray(v) for k, v in block.items()})
        if block and isinstance(block[0], dict):
            return pa.Table.from_pylist(list(block))
        return pa.table({"value": list(block)})
    raise ValueError(f"unknown batch_format {batch_format!r}")


def from_batch(batch) -> Block:
    """Normalize a user-returned batch back into a block. Arrow tables
    stay Arrow (the block type is preserved end to end). A pandas
    DataFrame can only come from a process that loaded pandas, so pandas
    is looked up, not imported."""
    if is_arrow(batch):
        return batch
    pd = sys.modules.get("pandas")
    if pd is not None and isinstance(batch, pd.DataFrame):
        return {k: batch[k].to_numpy() for k in batch.columns}
    if isinstance(batch, dict):
        return {k: np.asarray(v) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        return list(batch)
    if isinstance(batch, list):
        return batch
    raise TypeError(f"cannot convert batch of type {type(batch)} to a block")


def schema_of(block: Block):
    if is_arrow(block):
        return block.schema
    if is_columnar(block):
        return {k: v.dtype for k, v in block.items()}
    if block and isinstance(block[0], dict):
        return {k: type(v).__name__ for k, v in block[0].items()}
    return type(block[0]).__name__ if block else None
