"""ray_tpu_torch.data: streaming distributed datasets (reference:
python/ray/data/), the port's copy of ``ray_tpu.data``.

Lazy logical plans over blocks in the shared-memory object store, lowered
through an operator-fusing planner to a backpressured streaming executor
running ray_tpu_torch tasks/actors. A block is the port's own numpy
``Table`` (``block.py``), so the library imports without torch, pyarrow or
pandas: Data's CPU tasks pay for none of them. Consumption feeds the
card: ``iter_torch_batches`` stages batches in CUDA memory through pinned
host buffers and a side stream, ``streaming_split`` fans one execution
out to a gang of Train workers, and ``map_batches(num_gpus=)`` runs a UDF
on GPU actors.

The readers import what their format needs when they read: TFRecords,
WebDataset, SQL and Avro need the standard library alone; images need
PIL; HuggingFace, Delta, Iceberg and BigQuery need pyarrow.
"""

from ray_tpu_torch.data.block import (  # noqa: F401
    Block,
    BlockAccessor,
    BlockMetadata,
    Schema,
    Table,
)
from ray_tpu_torch.data.context import DataContext  # noqa: F401
from ray_tpu_torch.data.dataset import (  # noqa: F401
    Dataset,
    MaterializedDataset,
    from_arrow,
    from_blocks,
    from_huggingface,
    from_items,
    from_numpy,
    from_pandas,
    from_torch,
    range,
    range_tensor,
    read_avro,
    read_bigquery,
    read_binary_files,
    read_csv,
    read_datasource,
    read_delta,
    read_huggingface,
    read_iceberg,
    read_images,
    read_json,
    read_numpy,
    read_parquet,
    read_sql,
    read_text,
    read_tfrecords,
    read_webdataset,
)
from ray_tpu_torch.data.datasource import (  # noqa: F401
    _CLOUD_SOURCES,
    Datasource,
    ReadTask,
    make_gated_reader,
)

# cloud-warehouse readers whose client libraries are not installed:
# importable API surface that raises an actionable error at call time
for _name, _mod in _CLOUD_SOURCES.items():
    globals()[_name] = make_gated_reader(_name, _mod)
del _name, _mod
from ray_tpu_torch.data.grouped import (  # noqa: F401,E402
    AggregateFn,
    Count,
    GroupedData,
    Max,
    Mean,
    Min,
    Std,
    Sum,
)
from ray_tpu_torch.data.iterator import DataIterator  # noqa: F401,E402
from ray_tpu_torch.data import preprocessors  # noqa: F401,E402
from ray_tpu_torch.data.expr import col, lit  # noqa: F401,E402
from ray_tpu_torch.data.logical import (  # noqa: F401,E402
    ActorPoolStrategy,
    TaskPoolStrategy,
)

__all__ = [
    "Block", "BlockAccessor", "BlockMetadata", "DataContext", "Schema",
    "Table", "Dataset", "MaterializedDataset", "DataIterator",
    "Datasource", "ReadTask",
    "ActorPoolStrategy", "TaskPoolStrategy",
    "AggregateFn", "Sum", "Min", "Max", "Mean", "Count", "Std",
    "GroupedData", "preprocessors", "col", "lit",
    "range", "range_tensor", "from_items", "from_numpy", "from_arrow",
    "from_pandas", "from_blocks", "from_torch", "from_huggingface",
    "read_huggingface",
    "read_datasource", "read_parquet",
    "read_csv", "read_json", "read_numpy", "read_text",
    "read_binary_files", "read_tfrecords", "read_webdataset", "read_sql",
    "read_images", "read_avro", "read_bigquery", "read_delta",
    "read_iceberg",
] + list(_CLOUD_SOURCES)
