"""Dataset: the lazy, streaming, distributed dataset facade.

Reference: python/ray/data/dataset.py (Dataset :139) + read_api.py. Builds
a logical plan per transform; execution is deferred to consumption
(iter_batches/take/write_*) and runs on the streaming executor over the
ray_tpu_torch task runtime, blocks living in the shared-memory object store.

The port's copy of ``ray_tpu/data/dataset.py``. Differences:
``map``/``map_batches`` take ``num_gpus=`` where the reference takes
``num_chips=`` (an actor pool of GPU actors, each seeing its card as
``cuda:0``); there is no ``iter_jax_batches`` (``iter_torch_batches``
stages CUDA batches); ``rename_columns`` maps numpy batches (the
reference renames Arrow tables).
"""

from __future__ import annotations

import builtins
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import logical as L
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.datasource import (
    BinaryDatasource,
    CSVDatasource,
    Datasource,
    ItemsDatasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
    RangeDatasource,
    TextDatasource,
    TFRecordsDatasource,
)
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data.logical import ActorPoolStrategy, TaskPoolStrategy
from ray_tpu_torch.data.physical import RefBundle
from ray_tpu_torch.data.planner import Planner
from ray_tpu_torch.data.streaming_executor import StreamingExecutor


class Dataset:
    def __init__(self, logical_op: L.LogicalOperator,
                 context: Optional[DataContext] = None):
        self._logical_op = logical_op
        self._context = context or DataContext.get_current().copy()
        self._last_stats: Optional[str] = None

    # ---- transforms (lazy) ----

    def _map(self, name: str, kind: str, fn, *, compute=None,
             batch_size=None, batch_format=None, fn_args=(), fn_kwargs=None,
             num_gpus=0, fn_constructor_args=()) -> "Dataset":
        node = L.AbstractMap(
            name, self._logical_op, kind, fn, fn_args, fn_kwargs,
            batch_size=batch_size, batch_format=batch_format,
            compute=compute, num_gpus=num_gpus,
            fn_constructor_args=fn_constructor_args)
        return Dataset(node, self._context)

    def map(self, fn: Callable, *, compute=None, num_gpus: int = 0,
            fn_args=(), fn_kwargs=None) -> "Dataset":
        """Row-wise transform (reference: Dataset.map)."""
        return self._map("Map", "map_rows", fn, compute=compute,
                         num_gpus=num_gpus, fn_args=fn_args,
                         fn_kwargs=fn_kwargs)

    def map_batches(self, fn: Union[Callable, type], *,
                    batch_size: Optional[int] = None,
                    batch_format: Optional[str] = None,
                    compute=None, concurrency=None,
                    num_gpus: int = 0, fn_args=(), fn_kwargs=None,
                    fn_constructor_args=()) -> "Dataset":
        """Batch transform — the workhorse (reference: Dataset.map_batches).

        Passing a class (callable UDF) implies an actor pool; ``concurrency``
        sets its size (reference's concurrency arg)."""
        if isinstance(concurrency, int) and concurrency < 1:
            raise ValueError(
                f"concurrency must be >= 1, got {concurrency}")
        if compute is None and (isinstance(fn, type) or num_gpus):
            # Callable-class UDFs and GPU-using UDFs both need stateful
            # workers: GPUs bind to dedicated actor processes (see
            # runtime._prepare_request — num_gpus is actor-scoped).
            size = concurrency if isinstance(concurrency, int) else None
            lo, hi = (concurrency if isinstance(concurrency, tuple)
                      else (size, size))
            compute = ActorPoolStrategy(min_size=lo, max_size=hi)
        elif isinstance(concurrency, int) and compute is None:
            compute = TaskPoolStrategy(concurrency)
        if num_gpus and not isinstance(compute, ActorPoolStrategy):
            raise ValueError(
                "num_gpus requires an actor pool: pass compute="
                "ActorPoolStrategy(...) or omit compute")
        return self._map("MapBatches", "map_batches", fn,
                         batch_size=batch_size, batch_format=batch_format,
                         compute=compute, num_gpus=num_gpus,
                         fn_args=fn_args, fn_kwargs=fn_kwargs,
                         fn_constructor_args=fn_constructor_args)

    def flat_map(self, fn: Callable, **kw) -> "Dataset":
        return self._map("FlatMap", "flat_map", fn, **kw)

    def filter(self, fn: Optional[Callable] = None, *, expr=None,
               **kw) -> "Dataset":
        """Keep rows where ``fn(row)`` (or the vectorized ``expr``) is
        true. Expressions evaluate batch-at-once AND advertise their
        columns to the optimizer (reference: Dataset.filter(expr=...))."""
        from ray_tpu_torch.data.expr import Expr

        if isinstance(fn, Expr) and expr is None:
            fn, expr = None, fn
        if fn is None and expr is None:
            raise ValueError("filter() needs a row fn or an expr")
        if expr is not None:
            if fn is not None:
                raise ValueError("pass fn OR expr, not both")

            def mask(batch, _e=expr):
                m = np.asarray(_e.eval(batch), bool)
                return {k: np.asarray(v)[m] for k, v in batch.items()}

            ds = self._map(f"Filter[{expr!r}]", "map_batches", mask,
                           batch_format="numpy", **kw)
            ds._logical_op.expr_columns = tuple(sorted(expr.columns()))
            ds._logical_op.filter_expr = expr
            return ds
        return self._map("Filter", "filter", fn, **kw)

    def with_column(self, name: str, expr) -> "Dataset":
        """Add/replace a column from an expression (reference:
        Dataset.with_column)."""
        return self.with_columns({name: expr})

    def with_columns(self, exprs: Dict[str, Any]) -> "Dataset":
        from ray_tpu_torch.data.expr import Expr

        for k, e in exprs.items():
            if not isinstance(e, Expr):
                raise TypeError(f"{k}: expected an Expr, got {type(e)}")

        def add(batch, _es=tuple(exprs.items())):
            out = dict(batch)
            n = len(next(iter(batch.values()))) if batch else 0
            for k, e in _es:
                v = np.asarray(e.eval(batch))
                if v.ndim == 0:  # scalar literal: broadcast to the batch
                    v = np.full(n, v[()])
                out[k] = v
            return out

        ds = self._map(f"WithColumns{list(exprs)}", "map_batches", add,
                       batch_format="numpy")
        used = frozenset().union(*(e.columns() for e in exprs.values()))
        ds._logical_op.expr_columns = tuple(sorted(used))
        ds._logical_op.produces = tuple(exprs)
        return ds

    def add_column(self, col: str, fn: Callable) -> "Dataset":
        def add(batch: Dict[str, np.ndarray], _fn=fn, _col=col):
            batch = dict(batch)
            batch[_col] = np.asarray(_fn(batch))
            return batch
        return self._map(f"AddColumn[{col}]", "map_batches", add,
                         batch_format="numpy")

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def drop(batch: Dict[str, np.ndarray], _cols=tuple(cols)):
            return {k: v for k, v in batch.items() if k not in _cols}
        return self._map("DropColumns", "map_batches", drop,
                         batch_format="numpy")

    def select_columns(self, cols: List[str]) -> "Dataset":
        def select(batch: Dict[str, np.ndarray], _cols=tuple(cols)):
            return {k: batch[k] for k in _cols}
        ds = self._map("SelectColumns", "map_batches", select,
                       batch_format="numpy")
        # advertised projection: the optimizer pushes it into
        # column-prunable reads (optimizer.py: ProjectionPushdown)
        ds._logical_op.projection = tuple(cols)
        return ds

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        # zero-copy: a tensor column's inner shape is its array's own
        def rename(batch: Dict[str, np.ndarray], _m=dict(mapping)):
            return {_m.get(k, k): v for k, v in batch.items()}
        return self._map("RenameColumns", "map_batches", rename,
                         batch_format="numpy")

    def limit(self, n: int) -> "Dataset":
        return Dataset(L.Limit(self._logical_op, n), self._context)

    def repartition(self, num_blocks: int) -> "Dataset":
        node = L.AbstractAllToAll("Repartition", self._logical_op,
                                  "repartition", num_outputs=num_blocks)
        return Dataset(node, self._context)

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        node = L.AbstractAllToAll("RandomShuffle", self._logical_op,
                                  "random_shuffle", seed=seed,
                                  num_outputs=num_blocks)
        return Dataset(node, self._context)

    def sort(self, key: Union[str, List[str]],
             descending: bool = False) -> "Dataset":
        node = L.AbstractAllToAll("Sort", self._logical_op, "sort",
                                  key=key, descending=descending)
        return Dataset(node, self._context)

    def groupby(self, key: Union[str, List[str]]):
        from ray_tpu_torch.data.grouped import GroupedData
        return GroupedData(self, key)

    def union(self, *others: "Dataset") -> "Dataset":
        node = L.Union([self._logical_op] +
                       [o._logical_op for o in others])
        return Dataset(node, self._context)

    def zip(self, other: "Dataset") -> "Dataset":
        node = L.Zip(self._logical_op, other._logical_op)
        return Dataset(node, self._context)

    def random_sample(self, fraction: float,
                      *, seed: Optional[int] = None) -> "Dataset":
        def sample(batch: Dict[str, np.ndarray], _f=fraction, _s=seed):
            n = len(next(iter(batch.values()))) if batch else 0
            if _s is None:
                rng = np.random.default_rng()
            else:
                # Salt the seed per batch, else every batch would reuse
                # the identical keep-mask positions (periodic sample).
                import zlib
                first = next(iter(batch.values()))
                salt = zlib.crc32(np.ascontiguousarray(first).tobytes())
                rng = np.random.default_rng((_s, salt))
            keep = rng.random(n) < _f
            return {k: v[keep] for k, v in batch.items()}
        return self._map("RandomSample", "map_batches", sample,
                         batch_format="numpy")

    # ---- execution ----

    def _execute_bundles(self) -> Iterator[RefBundle]:
        planner = Planner(self._context)
        topo = planner.plan(self._logical_op)
        executor = StreamingExecutor(topo, self._context)
        gen = executor.execute()
        try:
            yield from gen
        finally:
            self._last_stats = executor.stats.summary()

    def _block_lists(self) -> Iterator[List[Block]]:
        for bundle in self._execute_bundles():
            yield ray_tpu_torch.get(bundle.blocks_ref)

    def iterator(self) -> DataIterator:
        return DataIterator(self._block_lists, lambda: self.stats())

    def materialize(self) -> "MaterializedDataset":
        """Execute now; hold blocks in the object store (reference:
        Dataset.materialize)."""
        bundles = list(self._execute_bundles())
        return MaterializedDataset(
            L.InputData(bundles), self._context, bundles)

    # ---- consumption ----

    def iter_rows(self):
        return self.iterator().iter_rows()

    def iter_batches(self, **kw):
        return self.iterator().iter_batches(**kw)

    def iter_torch_batches(self, **kw):
        return self.iterator().iter_torch_batches(**kw)

    def take(self, n: int = 20) -> List[Any]:
        out = []
        for row in self.limit(n).iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def take_batch(self, batch_size: int = 20,
                   batch_format: Optional[str] = None):
        fmt = batch_format or self._context.batch_format
        for b in self.limit(batch_size).iter_batches(
                batch_size=batch_size, batch_format=fmt,
                prefetch_batches=0):
            return b
        return {}

    def show(self, n: int = 20):
        for row in self.take(n):
            print(row)

    def count(self) -> int:
        node = self._logical_op
        # Fast path: pure reads know their row counts from metadata.
        if isinstance(node, L.Read):
            tasks = node.datasource.get_read_tasks(node.parallelism)
            rows = [t.metadata.num_rows for t in tasks]
            if all(r > 0 for r in rows):
                return sum(rows)
        return sum(bundle.num_rows for bundle in self._execute_bundles())

    # ---- global aggregates (reference: dataset.py sum/min/max/mean/std):
    # a streaming fold over batches on the driver — bounded memory, one
    # pass, no shuffle needed for whole-dataset scalars.

    def aggregate(self, *aggs) -> dict:
        states: dict = {a.name: None for a in aggs}
        for batch in self.iter_batches(batch_format="numpy"):
            for a in aggs:
                col = np.asarray(batch[a.on])
                s = states[a.name]
                if a.arrow_name == "sum":
                    states[a.name] = (0 if s is None else s) + col.sum()
                elif a.arrow_name == "min":
                    m = col.min()
                    states[a.name] = m if s is None else min(s, m)
                elif a.arrow_name == "max":
                    m = col.max()
                    states[a.name] = m if s is None else max(s, m)
                elif a.arrow_name == "count":
                    states[a.name] = (0 if s is None else s) + len(col)
                elif a.arrow_name in ("mean", "stddev"):
                    # Chan et al. parallel Welford merge of (n, mean, M2):
                    # numerically stable for large-mean data (the naive
                    # sumsq formula cancels catastrophically there)
                    col = col.astype(np.float64)
                    nb, mb = len(col), col.mean()
                    m2b = ((col - mb) ** 2).sum()
                    if s is None:
                        states[a.name] = [nb, mb, m2b]
                    else:
                        na, ma, m2a = s
                        n = na + nb
                        d = mb - ma
                        states[a.name] = [
                            n, ma + d * nb / n,
                            m2a + m2b + d * d * na * nb / n]
                else:
                    raise ValueError(
                        f"unknown aggregate {a.arrow_name!r}")
        out = {}
        for a in aggs:
            s = states[a.name]
            if a.arrow_name == "mean":
                out[a.name] = None if s is None or s[0] == 0 else s[1]
            elif a.arrow_name == "stddev":
                if s is None or s[0] < 2:
                    out[a.name] = None
                else:
                    n, _, m2 = s
                    out[a.name] = float(np.sqrt(m2 / (n - 1)))
            else:
                out[a.name] = s
        return out

    def _scalar_agg(self, arrow_name: str, on: str):
        from ray_tpu_torch.data.grouped import AggregateFn

        agg = AggregateFn(on, arrow_name)
        return self.aggregate(agg)[agg.name]

    def sum(self, on: str):
        return self._scalar_agg("sum", on)

    def min(self, on: str):
        return self._scalar_agg("min", on)

    def max(self, on: str):
        return self._scalar_agg("max", on)

    def mean(self, on: str):
        return self._scalar_agg("mean", on)

    def std(self, on: str):
        return self._scalar_agg("stddev", on)

    def schema(self):
        for bundle in self.limit(1)._execute_bundles():
            if bundle.metas and bundle.metas[0].schema is not None:
                return bundle.metas[0].schema
            blocks = ray_tpu_torch.get(bundle.blocks_ref)
            if blocks:
                return blocks[0].schema
        return None

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s.names) if s is not None else []

    def num_blocks(self) -> int:
        return sum(len(b.metas) or 1 for b in self._execute_bundles())

    def size_bytes(self) -> int:
        return sum(b.size_bytes for b in self._execute_bundles())

    def stats(self) -> str:
        return self._last_stats or ""

    def split(self, n: int, *, equal: bool = False
              ) -> List["MaterializedDataset"]:
        """Materialize and split into n datasets (reference: Dataset.split)."""
        mat = self.materialize()
        bundles = mat._bundles
        rows = sum(b.num_rows for b in bundles)
        per = math.ceil(rows / n)
        # Re-chunk bundle metadata row-wise via truncating tasks would be
        # heavy; split at bundle granularity, padding with empties.
        out: List[List[RefBundle]] = [[] for _ in builtins.range(n)]
        counts = [0] * n  # rows per split
        for b in bundles:
            idx = min(builtins.range(n), key=lambda i: counts[i]) \
                if equal else \
                min(builtins.range(n), key=lambda i: len(out[i]))
            out[idx].append(b)
            counts[idx] += b.num_rows
        return [MaterializedDataset(L.InputData(bs), self._context, bs)
                for bs in out]

    def streaming_split(self, n: int, *, equal: bool = True,
                        locality_hints=None):
        """n concurrent iterators over one streaming execution (reference:
        Dataset.streaming_split :1236 — the Train ingest path)."""
        from ray_tpu_torch.data.stream_split import make_stream_split_iterators
        return make_stream_split_iterators(self, n, equal=equal)

    # ---- writes ----

    def _write(self, path: str, file_format: str, **write_kwargs):
        node = L.Write(self._logical_op, path, file_format, write_kwargs)
        ds = Dataset(node, self._context)
        paths = []
        for bundle in ds._execute_bundles():
            for blocks in [ray_tpu_torch.get(bundle.blocks_ref)]:
                for b in blocks:
                    paths.extend(BlockAccessor(b).to_numpy()["path"].tolist())
        return paths

    def write_parquet(self, path: str, **kw):
        return self._write(path, "parquet", **kw)

    def write_csv(self, path: str, **kw):
        return self._write(path, "csv", **kw)

    def write_json(self, path: str, **kw):
        return self._write(path, "json", **kw)

    def write_numpy(self, path: str, **kw):
        return self._write(path, "npy", **kw)

    def write_bigquery(self, project_id: str, dataset: str) -> int:
        """Append to a BigQuery table via parallel load jobs; returns the
        row count written (reference: Dataset.write_bigquery)."""
        from ray_tpu_torch.data.datasource import write_bigquery_block

        @ray_tpu_torch.remote
        def _write_one(blocks, project_id=project_id, dataset=dataset):
            return sum(write_bigquery_block(b, project_id, dataset)
                       for b in blocks)

        refs = [_write_one.remote(bundle.blocks_ref)
                for bundle in self._execute_bundles()]
        return sum(ray_tpu_torch.get(refs))

    def write_tfrecords(self, path: str, column: str = "bytes"):
        """Write one TFRecord file per block from a bytes column, with
        valid masked CRC-32C framing (reference: Dataset.write_tfrecords;
        interoperable with TensorFlow readers)."""
        import os as _os

        from ray_tpu_torch.data.datasource import write_tfrecords_file

        _os.makedirs(path, exist_ok=True)

        @ray_tpu_torch.remote
        def _write_one(blocks, idx, path=path, column=column):
            out = _os.path.join(path, f"part-{idx:05d}.tfrecords")
            recs = []
            for b in blocks:
                recs.extend(BlockAccessor(b).to_numpy()[column].tolist())
            return write_tfrecords_file(recs, out)

        refs = [_write_one.remote(bundle.blocks_ref, i)
                for i, bundle in enumerate(self._execute_bundles())]
        return sum(ray_tpu_torch.get(refs))

    # ---- conversions ----

    def to_pandas(self, limit: Optional[int] = None):
        ds = self.limit(limit) if limit else self
        tables = [b for blocks in ds._block_lists() for b in blocks]
        merged = BlockAccessor.concat(tables)
        return merged.to_pandas()

    def to_arrow_refs(self):
        """Refs to the executed block lists (the reference's name; the
        blocks are the port's ``Table``s: ``block.to_arrow`` converts)."""
        return [b.blocks_ref for b in self._execute_bundles()]

    def __repr__(self):
        return f"Dataset({self._logical_op!r})"


class MaterializedDataset(Dataset):
    def __init__(self, logical_op, context, bundles: List[RefBundle]):
        super().__init__(logical_op, context)
        self._bundles = bundles

    def count(self) -> int:
        return sum(b.num_rows for b in self._bundles)


# ---- read API (reference: python/ray/data/read_api.py) ---------------------

def _auto_parallelism(ds: Datasource, ctx: DataContext) -> int:
    est = ds.estimate_inmemory_data_size()
    if est:
        return max(1, min(64, est // max(1, ctx.target_min_block_size)))
    return 8


def read_datasource(datasource: Datasource, *,
                    parallelism: int = -1, **_) -> Dataset:
    ctx = DataContext.get_current().copy()
    if parallelism is None or parallelism < 0:
        parallelism = (ctx.read_parallelism if ctx.read_parallelism > 0
                       else _auto_parallelism(datasource, ctx))
    return Dataset(L.Read(datasource, parallelism), ctx)


def range(n: int, *, parallelism: int = -1) -> Dataset:
    return read_datasource(RangeDatasource(n), parallelism=parallelism)


def range_tensor(n: int, *, shape=(1,), parallelism: int = -1) -> Dataset:
    return read_datasource(RangeDatasource(n, use_tensor=True,
                                           tensor_shape=tuple(shape)),
                           parallelism=parallelism)


def from_items(items: List[Any], *, parallelism: int = -1) -> Dataset:
    return read_datasource(ItemsDatasource(items), parallelism=parallelism)


def from_numpy(arr: np.ndarray) -> Dataset:
    block = BlockAccessor.batch_to_block({"data": arr})
    return from_blocks([block])


def from_arrow(table) -> Dataset:
    """A Dataset of one block converted from a ``pyarrow.Table`` (the
    port's block is a numpy ``Table``; pyarrow is imported by the
    caller's table)."""
    from ray_tpu_torch.data.block import from_arrow as _from_arrow
    return from_blocks([_from_arrow(table)])


def from_pandas(df) -> Dataset:
    from ray_tpu_torch.data.block import from_pandas as _from_pandas
    return from_blocks([_from_pandas(df)])


def from_blocks(blocks: List[Block]) -> Dataset:
    bundles = []
    for b in blocks:
        meta = BlockAccessor(b).get_metadata()
        ref = ray_tpu_torch.put([b])
        bundles.append(RefBundle(ref, meta.num_rows, meta.size_bytes,
                                 [meta]))
    ctx = DataContext.get_current().copy()
    return MaterializedDataset(L.InputData(bundles), ctx, bundles)


def read_parquet(paths, *, columns=None, parallelism: int = -1) -> Dataset:
    return read_datasource(ParquetDatasource(paths, columns),
                           parallelism=parallelism)


def read_csv(paths, *, parallelism: int = -1) -> Dataset:
    return read_datasource(CSVDatasource(paths), parallelism=parallelism)


def read_json(paths, *, parallelism: int = -1) -> Dataset:
    return read_datasource(JSONDatasource(paths), parallelism=parallelism)


def read_numpy(paths, *, parallelism: int = -1) -> Dataset:
    return read_datasource(NumpyDatasource(paths), parallelism=parallelism)


def read_text(paths, *, parallelism: int = -1) -> Dataset:
    return read_datasource(TextDatasource(paths), parallelism=parallelism)


def read_binary_files(paths, *, parallelism: int = -1) -> Dataset:
    return read_datasource(BinaryDatasource(paths), parallelism=parallelism)


def from_torch(torch_dataset, *, parallelism: int = -1) -> Dataset:
    from ray_tpu_torch.data.datasource import TorchDatasource

    return read_datasource(TorchDatasource(torch_dataset),
                           parallelism=parallelism)


def read_huggingface(path, *, split=None, parallelism: int = -1) -> Dataset:
    """Read a dataset saved by HF ``datasets``' ``save_to_disk`` (arrow
    shards; DatasetDict needs ``split=``) as a DISTRIBUTED read — the
    local-format sibling of ``from_huggingface`` (which converts an
    in-memory Dataset). No hub client or network involved."""
    from ray_tpu_torch.data.datasource import HuggingFaceDatasource

    return read_datasource(HuggingFaceDatasource(path, split=split),
                           parallelism=parallelism)


def read_tfrecords(paths, *, parallelism: int = -1) -> Dataset:
    return read_datasource(TFRecordsDatasource(paths),
                           parallelism=parallelism)


def read_webdataset(paths, *, parallelism: int = -1) -> Dataset:
    from ray_tpu_torch.data.datasource import WebDatasetDatasource

    return read_datasource(WebDatasetDatasource(paths),
                           parallelism=parallelism)


def read_sql(sql: str, connection_factory, *, parallelism: int = -1
             ) -> Dataset:
    from ray_tpu_torch.data.datasource import SQLDatasource

    return read_datasource(SQLDatasource(sql, connection_factory),
                           parallelism=parallelism)


def read_images(paths, *, size=None, mode=None,
                parallelism: int = -1) -> Dataset:
    from ray_tpu_torch.data.datasource import ImageDatasource

    return read_datasource(ImageDatasource(paths, size=size, mode=mode),
                           parallelism=parallelism)


def read_avro(paths, *, parallelism: int = -1) -> Dataset:
    from ray_tpu_torch.data.datasource import AvroDatasource

    return read_datasource(AvroDatasource(paths), parallelism=parallelism)


def from_huggingface(hf_dataset, *, parallelism: int = -1) -> Dataset:
    from ray_tpu_torch.data.datasource import huggingface_to_blocks

    return from_blocks(huggingface_to_blocks(hf_dataset, parallelism))


def read_bigquery(project_id: str, dataset: str = None, query: str = None,
                  *, parallelism: int = -1) -> Dataset:
    from ray_tpu_torch.data.datasource import BigQueryDatasource

    return read_datasource(
        BigQueryDatasource(project_id, dataset=dataset, query=query),
        parallelism=parallelism)


def read_iceberg(table_path: str, *, columns=None, snapshot_id=None,
                 parallelism: int = -1) -> Dataset:
    """Read a snapshot of an Apache Iceberg table — implemented in-tree
    over the open table format (JSON metadata + Avro manifest replay +
    parquet data files), no pyiceberg dependency (reference:
    _internal/datasource/iceberg_datasource.py). ``snapshot_id``
    time-travels to any retained snapshot."""
    from ray_tpu_torch.data.datasource import IcebergDatasource

    return read_datasource(
        IcebergDatasource(table_path, columns=columns,
                          snapshot_id=snapshot_id),
        parallelism=parallelism)


def read_delta(table_path: str, *, columns=None,
               parallelism: int = -1) -> Dataset:
    """Read the current snapshot of a Delta Lake table — implemented
    in-tree over the open table format (JSON transaction log + parquet
    checkpoint replay), no deltalake dependency (reference:
    read_delta/delta sharing datasources)."""
    from ray_tpu_torch.data.datasource import DeltaDatasource

    return read_datasource(DeltaDatasource(table_path, columns=columns),
                           parallelism=parallelism)
