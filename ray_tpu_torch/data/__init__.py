"""Data library: distributed datasets over object-store blocks (port of
``ray_tpu/data``).

Reference parity: ``python/ray/data`` -- lazy plans with stage fusion,
all-to-all shuffles, equal splits for Train ingest, actor-pool compute,
preprocessors -- built purely on tasks/actors/objects, with an overlapped
device feed (``Dataset.iter_device_batches``). Importing it loads neither
pyarrow nor pandas: the readers, writers and batch formats that need them
import them when called.
"""

from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu("data")

from ray_tpu_torch.data.dataset import (  # noqa: E402
    ActorPoolStrategy,
    Dataset,
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,
    range_tensor,
    read_binary_files,
    read_csv,
    read_json,
    read_parquet,
    read_text,
)
from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline  # noqa: E402
from ray_tpu_torch.data import preprocessors  # noqa: E402

__all__ = [
    "ActorPoolStrategy",
    "Dataset",
    "DatasetPipeline",
    "from_items",
    "from_arrow",
    "from_numpy",
    "from_pandas",
    "range",
    "range_tensor",
    "read_binary_files",
    "read_csv",
    "read_json",
    "read_parquet",
    "read_text",
    "preprocessors",
]
