"""Preprocessors: fit on a Dataset, transform Datasets/batches (port of
``ray_tpu/data/preprocessors.py``).

Reference parity: ``python/ray/data/preprocessors/`` — the fit/transform
contract of ``Preprocessor``, with the most-used concrete ones
(StandardScaler, MinMaxScaler, LabelEncoder, Concatenator, BatchMapper,
Chain).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


class Preprocessor:
    _fitted = False

    def fit(self, ds) -> "Preprocessor":
        self._fit(ds)
        self._fitted = True
        return self

    def transform(self, ds):
        if not self._fitted and self._needs_fit():
            raise RuntimeError(f"{type(self).__name__} must be fit first")
        return ds.map_batches(self._transform_batch, batch_format="numpy")

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def transform_batch(self, batch: dict) -> dict:
        if not self._fitted and self._needs_fit():
            raise RuntimeError(f"{type(self).__name__} must be fit first")
        return self._transform_batch(batch)

    def _needs_fit(self) -> bool:
        return True

    def _fit(self, ds) -> None:
        pass

    def _transform_batch(self, batch: dict) -> dict:
        raise NotImplementedError


class BatchMapper(Preprocessor):
    def __init__(self, fn: Callable[[dict], dict]):
        self.fn = fn

    def _needs_fit(self) -> bool:
        return False

    def _transform_batch(self, batch: dict) -> dict:
        return self.fn(batch)


class StandardScaler(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: dict = {}

    def _fit(self, ds) -> None:
        sums = {c: (0.0, 0.0, 0) for c in self.columns}
        for batch in ds.iter_batches(batch_format="numpy"):
            for c in self.columns:
                v = np.asarray(batch[c], dtype=np.float64)
                s, sq, n = sums[c]
                sums[c] = (s + v.sum(), sq + (v * v).sum(), n + v.size)
        for c, (s, sq, n) in sums.items():
            mean = s / n
            var = max(sq / n - mean * mean, 0.0)
            self.stats_[c] = (mean, np.sqrt(var) or 1.0)

    def _transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        for c in self.columns:
            mean, std = self.stats_[c]
            out[c] = (np.asarray(batch[c], np.float64) - mean) / std
        return out


class MinMaxScaler(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: dict = {}

    def _fit(self, ds) -> None:
        mins = {c: np.inf for c in self.columns}
        maxs = {c: -np.inf for c in self.columns}
        for batch in ds.iter_batches(batch_format="numpy"):
            for c in self.columns:
                v = np.asarray(batch[c], dtype=np.float64)
                mins[c] = min(mins[c], v.min())
                maxs[c] = max(maxs[c], v.max())
        for c in self.columns:
            span = maxs[c] - mins[c]
            self.stats_[c] = (mins[c], span if span else 1.0)

    def _transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        for c in self.columns:
            lo, span = self.stats_[c]
            out[c] = (np.asarray(batch[c], np.float64) - lo) / span
        return out


class LabelEncoder(Preprocessor):
    def __init__(self, label_column: str):
        self.label_column = label_column
        self.classes_: Optional[list] = None

    def _fit(self, ds) -> None:
        seen = set()
        for batch in ds.iter_batches(batch_format="numpy"):
            seen.update(np.asarray(batch[self.label_column]).tolist())
        self.classes_ = sorted(seen)

    def _transform_batch(self, batch: dict) -> dict:
        idx = {c: i for i, c in enumerate(self.classes_)}
        out = dict(batch)
        out[self.label_column] = np.asarray(
            [idx[v] for v in np.asarray(batch[self.label_column]).tolist()]
        )
        return out


class Concatenator(Preprocessor):
    """Merge feature columns into one float matrix column (the standard
    last step before tensor ingest)."""

    def __init__(self, output_column_name: str = "concat_out",
                 exclude: Optional[List[str]] = None, dtype=np.float32):
        self.output_column_name = output_column_name
        self.exclude = set(exclude or [])
        self.dtype = dtype

    def _needs_fit(self) -> bool:
        return False

    def _transform_batch(self, batch: dict) -> dict:
        cols = [c for c in batch if c not in self.exclude]
        mat = np.stack(
            [np.asarray(batch[c], dtype=self.dtype) for c in sorted(cols)],
            axis=-1,
        )
        out = {c: batch[c] for c in self.exclude}
        out[self.output_column_name] = mat
        return out


class Chain(Preprocessor):
    def __init__(self, *stages: Preprocessor):
        self.stages = list(stages)

    def fit(self, ds) -> "Chain":
        for stage in self.stages:
            stage.fit(ds)
            ds = stage.transform(ds)
        self._fitted = True
        return self

    def transform(self, ds):
        for stage in self.stages:
            ds = stage.transform(ds)
        return ds

    def _transform_batch(self, batch: dict) -> dict:
        for stage in self.stages:
            batch = stage.transform_batch(batch)
        return batch
