"""DatasetPipeline: windowed, overlapped execution of a Dataset plan (port
of ``ray_tpu/data/dataset_pipeline.py``).

Reference parity: ``python/ray/data/dataset_pipeline.py`` — split a
dataset into windows of blocks; each window's transform plan executes
while the previous window is being consumed, bounding memory to one
window (plus the prefetched next) instead of the whole dataset. ``repeat``
re-runs the window sequence for multi-epoch training ingest.

Window transforms stay LAZY (they ride Dataset's stage fusion); the
pipeline only adds scheduling: a prefetch thread materializes window
i+1 while the consumer iterates window i.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, List, Optional

from ray_tpu_torch.data.dataset import Dataset


class DatasetPipeline:
    def __init__(self, windows: List[Dataset], *, epochs: int = 1):
        self._windows = windows
        self._epochs = epochs

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_dataset(ds: Dataset, blocks_per_window: int) -> "DatasetPipeline":
        blocks = ds._blocks
        stages = ds._stages
        wins = [
            Dataset(blocks[i:i + blocks_per_window], list(stages),
                    ds._stats.child())
            for i in range(0, len(blocks), blocks_per_window)
        ] or [Dataset([], list(stages), ds._stats.child())]
        return DatasetPipeline(wins)

    def repeat(self, times: int = 2) -> "DatasetPipeline":
        return DatasetPipeline(self._windows, epochs=self._epochs * times)

    # -- lazy per-window transforms ---------------------------------------

    def _lift(self, method: str, *args, **kwargs) -> "DatasetPipeline":
        return DatasetPipeline(
            [getattr(w, method)(*args, **kwargs) for w in self._windows],
            epochs=self._epochs,
        )

    def map(self, fn: Callable) -> "DatasetPipeline":
        return self._lift("map", fn)

    def flat_map(self, fn: Callable) -> "DatasetPipeline":
        return self._lift("flat_map", fn)

    def filter(self, fn: Callable) -> "DatasetPipeline":
        return self._lift("filter", fn)

    def map_batches(self, fn: Callable, **kw) -> "DatasetPipeline":
        return self._lift("map_batches", fn, **kw)

    # -- consumption (window i+1 materializes while i is consumed) ---------

    def _iter_windows(self) -> Iterable[Dataset]:
        order = [w for _ in range(self._epochs) for w in self._windows]
        prefetched: Optional[threading.Thread] = None
        for i, win in enumerate(order):
            if prefetched is not None:
                prefetched.join()
            if i + 1 < len(order):
                nxt = order[i + 1]
                prefetched = threading.Thread(
                    target=lambda d=nxt: d._execute(), daemon=True)
                prefetched.start()
            else:
                prefetched = None
            yield win

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy") -> Iterable:
        for win in self._iter_windows():
            yield from win.iter_batches(
                batch_size=batch_size, batch_format=batch_format)

    def iter_rows(self) -> Iterable:
        for win in self._iter_windows():
            yield from win.iter_rows()

    def take(self, n: int = 20) -> list:
        out: list = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def count(self) -> int:
        return sum(w.count() for w in self._windows) * self._epochs

    @property
    def num_windows(self) -> int:
        return len(self._windows) * self._epochs

    def stats(self) -> str:
        return "\n".join(str(w.stats()) for w in self._windows)
