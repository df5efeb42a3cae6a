"""Datasources: pluggable readers/writers producing ReadTasks.

Reference: python/ray/data/read_api.py + python/ray/data/_internal/datasource/
(parquet, csv, json, numpy, range, binary, text datasources). A Datasource
plans itself into independent ``ReadTask``s — serializable thunks the
streaming executor runs as remote tasks, each yielding blocks.

The port's copy of part of ``ray_tpu/data/datasource.py``: range, items,
numpy, text, binary and torch sources need numpy alone; CSV, JSON and
parquet read through pyarrow, imported when a file is read, exactly as
the reference reads them, and their blocks are converted to the port's
``Table``. ``write_block``'s npy and json branches need no pyarrow; its
csv and parquet branches convert the block with ``to_arrow`` so both
packages write the same files.

The deferred readers: TFRecords, WebDataset, SQL and Avro need the
standard library alone; images import PIL, and HuggingFace, Delta,
Iceberg (their parquet data files) and BigQuery import pyarrow, each when
a file is read, and convert what they read with ``from_arrow``. The
TFRecord writer computes CRC-32C with the ``crc32c`` or ``google_crc32c``
extension when one is importable, else with the pure-Python table.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

from ray_tpu_torch.data.block import (Block, BlockAccessor, BlockMetadata,
                                      Table, _from_values, _object_array,
                                      _require, from_arrow, to_arrow)


class ReadTask:
    """A serializable unit of read work (reference:
    python/ray/data/datasource/datasource.py ReadTask)."""

    def __init__(self, read_fn: Callable[[], Iterable[Block]],
                 metadata: BlockMetadata):
        self._read_fn = read_fn
        self.metadata = metadata  # estimate; actual metadata computed on read

    def __call__(self) -> Iterable[Block]:
        return self._read_fn()


class Datasource:
    """Base class for custom datasources (reference:
    python/ray/data/datasource/datasource.py Datasource)."""

    def get_name(self) -> str:
        return type(self).__name__.replace("Datasource", "")

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        raise NotImplementedError


# ---- built-in sources ------------------------------------------------------

class RangeDatasource(Datasource):
    def __init__(self, n: int, use_tensor: bool = False,
                 tensor_shape: tuple = (1,)):
        self._n = n
        self._use_tensor = use_tensor
        self._tensor_shape = tensor_shape

    def estimate_inmemory_data_size(self):
        return self._n * 8 * int(np.prod(self._tensor_shape))

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        tasks = []
        n, k = self._n, max(1, parallelism)
        use_tensor, shape = self._use_tensor, self._tensor_shape
        for i in range(k):
            start = n * i // k
            end = n * (i + 1) // k
            if end <= start:
                continue

            def read(start=start, end=end):
                ids = np.arange(start, end, dtype=np.int64)
                if use_tensor:
                    data = np.broadcast_to(
                        ids.reshape((-1,) + (1,) * len(shape)),
                        (end - start,) + shape).copy()
                    yield BlockAccessor.batch_to_block({"data": data})
                else:
                    yield BlockAccessor.batch_to_block({"id": ids})

            meta = BlockMetadata(num_rows=end - start,
                                 size_bytes=(end - start) * 8)
            tasks.append(ReadTask(read, meta))
        return tasks


class ItemsDatasource(Datasource):
    def __init__(self, items: List[Any]):
        self._items = list(items)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        tasks = []
        n, k = len(self._items), max(1, parallelism)
        for i in range(k):
            chunk = self._items[n * i // k:n * (i + 1) // k]
            if not chunk:
                continue

            def read(chunk=chunk):
                yield BlockAccessor.rows_to_block(chunk)

            tasks.append(ReadTask(read, BlockMetadata(len(chunk), 0)))
        return tasks


def _expand_paths(paths, suffixes: Optional[List[str]] = None) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, files in os.walk(p):
                for f in sorted(files):
                    if f.startswith((".", "_")):
                        continue
                    if suffixes and not any(f.endswith(s) for s in suffixes):
                        continue
                    out.append(os.path.join(root, f))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"No input files found for {paths!r}")
    return out


class FileDatasource(Datasource):
    """Shared logic for file-based sources: split files across read tasks."""

    suffixes: Optional[List[str]] = None
    # decoded-size multiplier for read-parallelism inference (reference:
    # ParquetDatasource's encoding-ratio estimate — on-disk parquet/
    # compressed formats expand in memory)
    size_multiplier: float = 1.0

    def __init__(self, paths):
        self._paths = _expand_paths(paths, self.suffixes)

    def estimate_inmemory_data_size(self):
        try:
            return int(sum(os.path.getsize(p) for p in self._paths)
                       * self.size_multiplier)
        except OSError:
            return None

    def read_file(self, path: str) -> Iterable[Block]:
        raise NotImplementedError

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        tasks = []
        groups = np.array_split(np.asarray(self._paths, dtype=object),
                                max(1, min(parallelism, len(self._paths))))
        for grp in groups:
            paths = [str(p) for p in grp]
            if not paths:
                continue

            def read(paths=paths, self=self):
                for p in paths:
                    yield from self.read_file(p)

            size = sum(os.path.getsize(p) for p in paths
                       if os.path.exists(p))
            tasks.append(ReadTask(read, BlockMetadata(
                num_rows=0, size_bytes=size, input_files=paths)))
        return tasks


class ParquetDatasource(FileDatasource):
    size_multiplier = 5.0  # columnar compression expands in memory

    suffixes = [".parquet"]
    supports_column_pruning = True
    supports_predicate_pushdown = True

    def __init__(self, paths, columns: Optional[List[str]] = None):
        _require("pyarrow.parquet")
        super().__init__(paths)
        self._columns = columns
        self._filter = None  # pyarrow.dataset expression
        self._expr = None    # framework Expr (row-group stat pruning)

    def with_columns(self, columns: List[str]) -> "ParquetDatasource":
        """Pruned clone (projection pushdown target)."""
        import copy

        out = copy.copy(self)
        out._columns = list(columns)
        return out

    def with_filter(self, pa_expr, expr=None) -> "ParquetDatasource":
        """Filtered clone (predicate pushdown target); multiple pushed
        filters AND together. ``expr`` is the framework Expr used for
        row-group statistics pruning (the pyarrow expression alone is
        opaque to interval analysis)."""
        import copy

        out = copy.copy(self)
        out._filter = (pa_expr if out._filter is None
                       else out._filter & pa_expr)
        if expr is not None:
            out._expr = (expr if getattr(out, "_expr", None) is None
                         else out._expr & expr)
        return out

    def read_file(self, path: str):
        pa = _require("pyarrow")
        pq = _require("pyarrow.parquet")
        pf = pq.ParquetFile(path)
        if self._filter is None:
            for batch in pf.iter_batches(columns=self._columns):
                yield from_arrow(pa.Table.from_batches([batch]))
            return
        # explicit row-group statistics pruning: a group whose min/max
        # bounds PROVE the predicate empty is never read off disk
        # (reference: fragment-metadata pruning in
        # _internal/datasource/parquet_datasource.py); survivors filter
        # vectorized per batch before the block materializes
        expr = getattr(self, "_expr", None)
        n_groups = pf.metadata.num_row_groups
        kept = list(range(n_groups))
        if expr is not None:
            from ray_tpu_torch.data.expr import row_group_may_match

            kept = []
            for i in range(n_groups):
                rg = pf.metadata.row_group(i)
                stats = {}
                for j in range(rg.num_columns):
                    c = rg.column(j)
                    if (c.statistics is not None
                            and c.statistics.has_min_max):
                        stats[c.path_in_schema] = (c.statistics.min,
                                                   c.statistics.max)
                if row_group_may_match(expr, stats):
                    kept.append(i)
        # observability (tests + stats debugging; one process-local scan)
        self.last_scan_row_groups = (n_groups, len(kept))
        if not kept:
            return
        # the residual filter may reference columns the projection
        # pruned (the scanner-based predicate needs them only
        # transiently): read the union, filter, then re-project
        read_cols = self._columns
        if read_cols is not None:
            if expr is not None:
                read_cols = sorted(set(read_cols) | set(expr.columns()))
            else:
                read_cols = None  # unknown filter columns: read all
        for batch in pf.iter_batches(row_groups=kept, columns=read_cols):
            t = pa.Table.from_batches([batch]).filter(self._filter)
            if self._columns is not None and t.column_names != self._columns:
                t = t.select(self._columns)
            if t.num_rows:
                yield from_arrow(t)


class _ScannedTextDatasource(FileDatasource):
    """Shared base for row-oriented text formats (CSV/JSON) with
    EARLY-SKIP predicate pushdown: there are no statistics to prune on,
    but a pushed filter applies per record batch inside the scanner —
    non-matching rows are dropped before any block materializes or
    crosses the object store (reference: the planner pushes filters
    only into parquet; this extends the same rule to text scans)."""

    format: str = ""
    supports_predicate_pushdown = True

    def __init__(self, paths):
        _require(f"pyarrow.{self.format}")
        super().__init__(paths)
        self._filter = None

    def with_filter(self, pa_expr, expr=None):
        import copy

        out = copy.copy(self)
        out._filter = (pa_expr if out._filter is None
                       else out._filter & pa_expr)
        return out

    def _read_table(self, path: str):
        raise NotImplementedError

    def read_file(self, path: str):
        if self._filter is None:
            yield from_arrow(self._read_table(path))
            return
        pa = _require("pyarrow")
        pads = _require("pyarrow.dataset")
        scan = pads.dataset(path, format=self.format)
        for batch in scan.to_batches(filter=self._filter):
            if batch.num_rows:
                yield from_arrow(pa.Table.from_batches([batch]))


class CSVDatasource(_ScannedTextDatasource):
    suffixes = [".csv"]
    format = "csv"

    def _read_table(self, path: str):
        return _require("pyarrow.csv").read_csv(path)


class JSONDatasource(_ScannedTextDatasource):
    suffixes = [".json", ".jsonl"]
    format = "json"

    def _read_table(self, path: str):
        return _require("pyarrow.json").read_json(path)


class NumpyDatasource(FileDatasource):
    suffixes = [".npy"]

    def read_file(self, path: str):
        arr = np.load(path)
        yield BlockAccessor.batch_to_block({"data": arr})


class TextDatasource(FileDatasource):
    def read_file(self, path: str):
        with open(path, "r", errors="replace") as f:
            lines = [ln.rstrip("\n") for ln in f]
        yield Table({"text": _object_array(lines)}, {"text": "string"})


class BinaryDatasource(FileDatasource):
    def read_file(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        yield Table({"bytes": _object_array([data]),
                     "path": _object_array([path])},
                    {"bytes": "binary", "path": "string"})


class TFRecordsDatasource(FileDatasource):
    """Minimal TFRecord reader (uncompressed): parses the framing format
    (length/crc framing per the TFRecord spec) and yields raw example
    bytes; decoding protos is left to a downstream map (torch/tf-free).
    As the reference's, it does not check the CRCs."""

    suffixes = [".tfrecords", ".tfrecord"]

    def read_file(self, path: str):
        import struct
        records = []
        with open(path, "rb") as f:
            while True:
                header = f.read(8)
                if len(header) < 8:
                    break
                (length,) = struct.unpack("<Q", header)
                f.read(4)  # length crc
                records.append(f.read(length))
                f.read(4)  # data crc
        yield Table({"bytes": _object_array(records)}, {"bytes": "binary"})


class WebDatasetDatasource(FileDatasource):
    """WebDataset-style tar shards (reference:
    _internal/datasource/webdataset_datasource.py): each sample is the
    group of tar members sharing a basename; extensions become columns
    holding raw bytes (decoding is a downstream map)."""

    suffixes = [".tar"]

    def read_file(self, path: str):
        import tarfile

        samples: dict = {}
        order: List[str] = []
        with tarfile.open(path) as tf:
            for member in tf:
                if not member.isfile():
                    continue
                # webdataset convention: split at the first dot of the LAST
                # path component (dotted directories stay in the key)
                dirname, _, fname = member.name.rpartition("/")
                stem, _, ext = fname.partition(".")
                base = f"{dirname}/{stem}" if dirname else stem
                data = tf.extractfile(member).read()
                if base not in samples:
                    samples[base] = {"__key__": base}
                    order.append(base)
                samples[base][ext or "bin"] = data
        if not order:
            return
        cols = sorted({k for s in samples.values() for k in s})
        yield Table(
            {c: _object_array([samples[b].get(c) for b in order])
             for c in cols},
            {c: "string" if c == "__key__" else "binary" for c in cols})


class SQLDatasource(Datasource):
    """Rows from a DBAPI connection factory (reference:
    _internal/datasource/sql_datasource.py; works out of the box with
    stdlib sqlite3). Each page of rows is one block, its columns typed
    from the Python values as Arrow infers them."""

    def __init__(self, sql: str, connection_factory):
        self._sql = sql
        self._factory = connection_factory

    def estimate_inmemory_data_size(self):
        return None

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        sql, factory = self._sql, self._factory

        def read():
            conn = factory()
            try:
                cur = conn.cursor()
                cur.execute(sql)
                names = [d[0] for d in cur.description]
                # page the cursor so huge result sets stream as bounded
                # blocks instead of one fetchall() materialization
                while True:
                    rows = cur.fetchmany(10_000)
                    if not rows:
                        break
                    cols, kinds = {}, {}
                    for i, n in enumerate(names):
                        cols[n], kind = _from_values([r[i] for r in rows])
                        if kind:
                            kinds[n] = kind
                    yield Table(cols, kinds)
            finally:
                conn.close()

        return [ReadTask(read, BlockMetadata(num_rows=0, size_bytes=0,
                                             input_files=[]))]


class ImageDatasource(FileDatasource):
    """Decoded images as tensor columns (reference:
    _internal/datasource/image_datasource.py). Columns: ``image`` (HWC
    uint8 tensor) + ``path``. ``size=(H, W)`` resizes on read so blocks
    have a uniform tensor shape; ``mode`` forces a PIL color mode."""

    suffixes = [".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp"]

    def __init__(self, paths, size: Optional[tuple] = None,
                 mode: Optional[str] = None):
        super().__init__(paths)
        self._size = tuple(size) if size else None
        self._mode = mode

    def read_file(self, path: str):
        from PIL import Image

        img = Image.open(path)
        if self._mode:
            img = img.convert(self._mode)
        if self._size:
            # PIL takes (W, H); the API takes (H, W) like the reference
            img = img.resize((self._size[1], self._size[0]))
        arr = np.asarray(img)
        yield BlockAccessor.batch_to_block(
            {"image": arr[None, ...], "path": np.asarray([path])})


# ---- Avro object container files (pure-python, no fastavro) ---------------

class _AvroReader:
    """Minimal Avro OCF decoder per the 1.11 spec: null/deflate codecs;
    null, boolean, int, long, float, double, bytes, string, record, enum,
    array, map, union, and fixed types."""

    def __init__(self, buf: bytes):
        self._b = buf
        self._i = 0

    def _read(self, n: int) -> bytes:
        out = self._b[self._i:self._i + n]
        if len(out) < n:
            raise EOFError("truncated avro data")
        self._i += n
        return out

    def long(self) -> int:
        shift, acc = 0, 0
        while True:
            byte = self._b[self._i]
            self._i += 1
            acc |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)  # zigzag

    def bytes_(self) -> bytes:
        return self._read(self.long())

    def string(self) -> str:
        return self.bytes_().decode("utf-8")

    def value(self, schema, named) -> Any:
        import struct

        if isinstance(schema, str) and schema in named:
            schema = named[schema]
        if isinstance(schema, list):   # union
            return self.value(schema[self.long()], named)
        t = schema["type"] if isinstance(schema, dict) else schema
        if t == "null":
            return None
        if t == "boolean":
            return self._read(1)[0] == 1
        if t in ("int", "long"):
            return self.long()
        if t == "float":
            return struct.unpack("<f", self._read(4))[0]
        if t == "double":
            return struct.unpack("<d", self._read(8))[0]
        if t == "bytes":
            return self.bytes_()
        if t == "string":
            return self.string()
        if t == "record":
            named[schema["name"]] = schema
            return {f["name"]: self.value(f["type"], named)
                    for f in schema["fields"]}
        if t == "enum":
            named[schema["name"]] = schema
            return schema["symbols"][self.long()]
        if t == "fixed":
            named[schema["name"]] = schema
            return self._read(schema["size"])
        if t == "array":
            out = []
            while True:
                n = self.long()
                if n == 0:
                    break
                if n < 0:
                    n = -n
                    self.long()  # skip byte-size hint
                out.extend(self.value(schema["items"], named)
                           for _ in range(n))
            return out
        if t == "map":
            out = {}
            while True:
                n = self.long()
                if n == 0:
                    break
                if n < 0:
                    n = -n
                    self.long()
                for _ in range(n):
                    k = self.string()  # key MUST decode before the value
                    out[k] = self.value(schema["values"], named)
            return out
        raise ValueError(f"unsupported avro type {t!r}")


def read_avro_rows(path: str) -> List[dict]:
    """Decode one Avro OCF into plain Python rows (shared by
    AvroDatasource and the Iceberg manifest reader, whose nested
    manifest-entry records should not round-trip through a block)."""
    import json
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    r = _AvroReader(data)
    if r._read(4) != b"Obj\x01":
        raise ValueError(f"{path} is not an avro container file")
    meta = {}
    while True:
        n = r.long()
        if n == 0:
            break
        if n < 0:
            n = -n
            r.long()
        for _ in range(n):
            k = r.string()  # key MUST decode before the value
            meta[k] = r.bytes_()
    schema = json.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode()
    sync = r._read(16)

    rows: List[dict] = []
    while r._i < len(r._b):
        count = r.long()
        size = r.long()
        payload = r._read(size)
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        elif codec != "null":
            raise ValueError(f"unsupported avro codec {codec!r}")
        block = _AvroReader(payload)
        named: dict = {}
        for _ in range(count):
            v = block.value(schema, named)
            rows.append(v if isinstance(v, dict) else {"value": v})
        if r._read(16) != sync:
            raise ValueError(f"{path}: bad sync marker (corrupt file)")
    return rows


class AvroDatasource(FileDatasource):
    """Avro object container files (reference:
    _internal/datasource/avro_datasource.py uses fastavro; here the
    container + binary encoding are decoded directly)."""

    suffixes = [".avro"]

    def read_file(self, path: str):
        rows = read_avro_rows(path)
        if rows:
            yield BlockAccessor.rows_to_block(rows)


# ---- external-framework converters ----------------------------------------

class TorchDatasource(Datasource):
    """Map-style ``torch.utils.data.Dataset`` split by index ranges
    (reference: read_api.from_torch)."""

    def __init__(self, torch_dataset):
        self._ds = torch_dataset

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        n = len(self._ds)
        ds = self._ds
        tasks = []
        k = max(1, min(parallelism, n))
        for i in range(k):
            start, end = n * i // k, n * (i + 1) // k
            if end <= start:
                continue

            def read(start=start, end=end):
                rows = []
                for j in range(start, end):
                    item = ds[j]
                    if isinstance(item, dict):
                        item = {k2: _to_numpy_value(v)
                                for k2, v in item.items()}
                    elif isinstance(item, (tuple, list)):
                        # e.g. TensorDataset yields (x, y): one column per
                        # element (a tuple cell has no arrow type)
                        item = {f"item_{idx}": _to_numpy_value(v)
                                for idx, v in enumerate(item)}
                    else:
                        item = {"item": _to_numpy_value(item)}
                    rows.append(item)
                yield BlockAccessor.rows_to_block(rows)

            tasks.append(ReadTask(read, BlockMetadata(end - start, 0)))
        return tasks


def _to_numpy_value(v):
    try:
        import torch
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
    except ImportError:
        pass
    if isinstance(v, (list, tuple)):
        return type(v)(_to_numpy_value(x) for x in v)
    return v


def huggingface_to_blocks(hf_dataset, parallelism: int) -> List[Block]:
    """An HF ``datasets.Dataset`` is arrow-backed: slice its table into
    blocks, each converted with ``from_arrow`` (reference:
    read_api.from_huggingface)."""
    # select/shuffle/filter keep the full backing table plus an indices
    # mapping — materialize it or we'd read the unfiltered rows
    if getattr(hf_dataset, "_indices", None) is not None:
        hf_dataset = hf_dataset.flatten_indices()
    table = hf_dataset.data.table if hasattr(hf_dataset, "data") else None
    if table is None:
        raise TypeError(
            "from_huggingface expects a materialized datasets.Dataset "
            f"(got {type(hf_dataset).__name__}); for IterableDataset, "
            "materialize first or use from_items")
    table = table.combine_chunks()
    n = table.num_rows
    k = max(1, min(parallelism if parallelism > 0 else 8, max(n, 1)))
    return [from_arrow(table.slice(n * i // k, n * (i + 1) // k - n * i // k))
            for i in range(k) if n * (i + 1) // k > n * i // k]


def _require_bigquery():
    """Actionable gated-import error, consistent with make_gated_reader."""
    try:
        from google.cloud import bigquery  # noqa: F401
    except ImportError:
        raise ImportError(
            "read_bigquery/write_bigquery require the optional dependency "
            "'google-cloud-bigquery', which is not installed in this "
            "environment. Install it, or export the table to parquet/csv "
            "and use read_parquet/read_csv.") from None


class BigQueryDatasource(Datasource):
    """BigQuery tables/queries via the google-cloud-bigquery client
    (reference: _internal/datasource/bigquery_datasource.py). A table
    read is split into row ranges across read tasks; a query runs once
    and is sliced. The client's Arrow results become blocks through
    ``from_arrow``."""

    def __init__(self, project_id: str, dataset: Optional[str] = None,
                 query: Optional[str] = None):
        if (dataset is None) == (query is None):
            raise ValueError(
                "read_bigquery: pass exactly one of dataset='ds.table' "
                "or query='SELECT ...'")
        self._project = project_id
        self._dataset = dataset
        self._query = query

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        _require_bigquery()
        project, dataset, query = self._project, self._dataset, self._query

        if query is not None:
            def read_query():
                from google.cloud import bigquery

                client = bigquery.Client(project=project)
                table = client.query(query).to_arrow()
                if table.num_rows:
                    yield from_arrow(table)

            return [ReadTask(read_query, BlockMetadata(0, 0))]

        from google.cloud import bigquery

        client = bigquery.Client(project=project)
        bq_table = client.get_table(dataset)
        n = bq_table.num_rows
        k = max(1, min(parallelism if parallelism > 0 else 8, max(n, 1)))
        tasks = []
        for i in range(k):
            start, end = n * i // k, n * (i + 1) // k
            if end <= start:
                continue

            def read(start=start, end=end):
                from google.cloud import bigquery as bq

                rows = bq.Client(project=project).list_rows(
                    dataset, start_index=start, max_results=end - start)
                table = rows.to_arrow()
                if table.num_rows:
                    yield from_arrow(table)

            tasks.append(ReadTask(read, BlockMetadata(end - start, 0)))
        return tasks


def write_bigquery_block(block: Block, project_id: str, dataset: str
                         ) -> int:
    """Append one block to a BigQuery table via a load job (the block
    goes as parquet, laid out by ``to_arrow``)."""
    import io

    pq = _require("pyarrow.parquet")
    _require_bigquery()
    from google.cloud import bigquery

    client = bigquery.Client(project=project_id)
    buf = io.BytesIO()
    pq.write_table(to_arrow(block), buf)
    buf.seek(0)
    job = client.load_table_from_file(
        buf, dataset,
        job_config=bigquery.LoadJobConfig(
            source_format=bigquery.SourceFormat.PARQUET))
    job.result()
    return block.num_rows


# ---- gated cloud datasources (backing libraries not installed) ------------

_CLOUD_SOURCES = {
    "read_lance": "lance",
    "read_mongo": "pymongo",
    "read_databricks_tables": "databricks.sql",
    "read_clickhouse": "clickhouse_connect",
    "read_snowflake": "snowflake.connector",
}


def make_gated_reader(api_name: str, module: str):
    def _reader(*args, **kwargs):
        import importlib
        try:
            importlib.import_module(module)
        except ImportError:
            raise ImportError(
                f"{api_name} requires the optional dependency {module!r}, "
                "which is not installed in this environment. Install it, "
                "or load via the generic paths: read_parquet/read_sql/"
                "Datasource plugins cover these formats' export paths."
            ) from None
        raise NotImplementedError(
            f"{api_name}: {module!r} is present but this connector is not "
            "implemented yet; use a Datasource plugin (data/datasource.py)")
    _reader.__name__ = api_name
    return _reader


# ---- writers ---------------------------------------------------------------

def write_block(block: Block, path: str, file_format: str, index: int,
                **kwargs) -> str:
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{index:06d}.{file_format}")
    if file_format == "parquet":
        _require("pyarrow.parquet").write_table(to_arrow(block), out,
                                                **kwargs)
    elif file_format == "csv":
        _require("pyarrow.csv").write_csv(to_arrow(block), out)
    elif file_format == "json":
        import json
        rows = list(BlockAccessor(block).iter_rows())
        with open(out, "w") as f:
            for r in rows:
                f.write(json.dumps(_json_safe(r)) + "\n")
    elif file_format == "npy":
        data = BlockAccessor(block).to_numpy()
        if len(data) == 1:
            np.save(out, next(iter(data.values())))
        else:
            np.savez(out, **data)
    else:
        raise ValueError(f"Unknown file format {file_format!r}")
    return out


def _json_safe(v):
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, bytes):
        return v.decode("utf-8", errors="replace")
    return v


_DELTA_PARTITION_TYPES = {
    "string": "string", "integer": "int32", "long": "int64",
    "short": "int16", "byte": "int8", "double": "float64",
    "float": "float32", "boolean": "bool", "date": "date32",
}


def _delta_partition_array(delta_type: str, val: Optional[str], n: int):
    """Materialize one partition column: n copies of the add action's
    string-serialized partition value, converted to the schema type (a
    ``pyarrow`` array: the Delta reader assembles each file's table in
    Arrow, then converts it with ``from_arrow``)."""
    pa = _require("pyarrow")

    pa_name = _DELTA_PARTITION_TYPES.get(delta_type)
    if pa_name is None:
        raise ValueError(
            f"unsupported Delta partition column type {delta_type!r} "
            f"(supported: {sorted(_DELTA_PARTITION_TYPES)})")
    typ = getattr(pa, pa_name)()
    if val is None:
        return pa.nulls(n, typ)
    v: Any = val
    if delta_type == "boolean":
        v = val == "true"
    elif delta_type == "date":
        import datetime

        v = datetime.date.fromisoformat(val)
    elif delta_type in ("integer", "long", "short", "byte"):
        v = int(val)
    elif delta_type in ("float", "double"):
        v = float(val)
    return pa.array([v] * n, type=typ)


def _delta_map(v) -> dict:
    """Normalize a Delta action's map field: JSON commits decode as
    dicts, but parquet checkpoints store map<string,string> which
    to_pydict yields as a list of (key, value) tuples."""
    if not v:
        return {}
    if isinstance(v, dict):
        return v
    return dict(v)


class DeltaDatasource(Datasource):
    """Delta Lake table reader, dependency-free beyond pyarrow (reference:
    _internal/datasource/delta_sharing_datasource.py fills this role via
    the deltalake lib; the table format itself is open: a parquet data
    set plus a JSON transaction log). Reconstructs the CURRENT snapshot:
    parquet checkpoint (if any) + JSON commits after it, applying
    add/remove actions in order. Partition columns (stored only in the
    add actions' partitionValues, not in the data files) are
    materialized back into each block with their schema types. Time
    travel / deletion vectors / column mapping are out of scope and
    refuse loudly."""

    def __init__(self, table_path: str,
                 columns: Optional[List[str]] = None):
        if "://" in table_path and not table_path.startswith("file://"):
            raise ValueError(
                f"read_delta reads local filesystems (got "
                f"{table_path!r}); mount or sync the table locally")
        if table_path.startswith("file://"):
            table_path = table_path[len("file://"):]
        self._root = table_path.rstrip("/")
        self._columns = columns
        # path -> partitionValues; plus the latest metaData's partition
        # schema {col: delta type}
        self._files, self._part_schema = self._live_files()

    def get_name(self):
        return "Delta"

    # -- log replay -------------------------------------------------------
    def _log_dir(self):
        return os.path.join(self._root, "_delta_log")

    def _find_checkpoint(self, log: str):
        """Latest COMPLETE checkpoint by listing the log dir (the
        _last_checkpoint hint is best-effort per the protocol — it can be
        missing or stale while checkpoint files exist, and trusting it
        alone silently drops every file the checkpoint compacted)."""
        import re

        single = re.compile(r"^(\d{20})\.checkpoint\.parquet$")
        multi = re.compile(
            r"^(\d{20})\.checkpoint\.(\d{10})\.(\d{10})\.parquet$")
        # keyed by (version, declared part count) so a complete 2-part
        # checkpoint is never mixed with / shadowed by an abandoned
        # 3-part attempt at the same version
        found: Dict[tuple, Dict[int, str]] = {}
        for name in os.listdir(log):
            m = single.match(name)
            if m:
                found.setdefault((int(m.group(1)), 1), {})[1] = name
                continue
            m = multi.match(name)
            if m:
                key = (int(m.group(1)), int(m.group(3)))
                found.setdefault(key, {})[int(m.group(2))] = name
        for v, total in sorted(found, reverse=True):
            parts = found[(v, total)]
            if len(parts) == total:
                return v, [os.path.join(log, parts[i + 1])
                           for i in range(total)]
        return -1, []

    def _live_files(self):
        import json

        log = self._log_dir()
        if not os.path.isdir(log):
            raise FileNotFoundError(
                f"{self._root} is not a Delta table (no _delta_log)")
        ckpt_version, ckpt_parts = self._find_checkpoint(log)
        live: Dict[str, Dict[str, Optional[str]]] = {}
        meta_holder: Dict[str, Any] = {}

        def check_metadata(md):
            if not md:
                return
            conf = _delta_map(md.get("configuration"))
            if conf.get("delta.columnMapping.mode", "none") != "none":
                raise ValueError(
                    "unsupported Delta feature: column mapping")
            meta_holder["meta"] = md

        def check_protocol(proto):
            if proto and int(proto.get("minReaderVersion") or 1) > 1:
                feats = proto.get("readerFeatures") or []
                raise ValueError(
                    f"unsupported Delta protocol: minReaderVersion="
                    f"{proto.get('minReaderVersion')} "
                    f"(readerFeatures={feats}) — this reader implements "
                    f"version 1 (plain parquet + log)")

        def apply_add(a):
            if a.get("deletionVector"):
                raise ValueError(
                    "unsupported Delta feature: deletion vectors")
            live[a["path"]] = _delta_map(a.get("partitionValues"))

        for part in ckpt_parts:
            pq = _require("pyarrow.parquet")

            # project to the action columns consumed — checkpoints also
            # carry stats/txn/remove for every live file, and reading
            # those just to discard them stalls the driver on big tables
            names = pq.read_schema(part).names
            want = [c for c in ("add", "metaData", "protocol")
                    if c in names]
            cols = pq.read_table(part, columns=want).to_pydict()
            # metaData/protocol actions usually live IN the checkpoint
            # once one exists — gate there too, not just in JSON commits
            for md in cols.get("metaData") or []:
                check_metadata(md)
            for proto in cols.get("protocol") or []:
                check_protocol(proto)
            for add in cols.get("add") or []:
                if add and add.get("path"):
                    apply_add(add)
        commits = sorted(
            f for f in os.listdir(log)
            if f.endswith(".json") and f[:20].isdigit()
            and int(f[:20]) > ckpt_version)
        for name in commits:
            with open(os.path.join(log, name)) as f:
                for line in f:
                    if not line.strip():
                        continue
                    action = json.loads(line)
                    if "add" in action:
                        apply_add(action["add"])
                    elif "remove" in action:
                        live.pop(action["remove"]["path"], None)
                    elif "metaData" in action:
                        check_metadata(action["metaData"])
                    elif "protocol" in action:
                        check_protocol(action["protocol"])
        from urllib.parse import unquote

        part_schema = self._partition_schema(meta_holder.get("meta"), live)
        return ([(os.path.join(self._root, unquote(p)), pv)
                 for p, pv in live.items()], part_schema)

    @staticmethod
    def _partition_schema(meta, live) -> Dict[str, str]:
        """{partition column: delta type} from the latest metaData."""
        import json

        pcols = (meta or {}).get("partitionColumns") or []
        if not pcols:
            if any(pv for _, pv in live.items()):
                raise ValueError(
                    "Delta table has partitionValues but no metaData "
                    "action with partitionColumns was found in the log")
            return {}
        schema = json.loads(meta["schemaString"])
        types = {f["name"]: f["type"] for f in schema.get("fields", [])}
        out = {}
        for c in pcols:
            t = types.get(c)
            if not isinstance(t, str):
                raise ValueError(
                    f"unsupported Delta partition column {c!r}: type "
                    f"{t!r} is not a primitive")
            if t not in _DELTA_PARTITION_TYPES:
                raise ValueError(
                    f"unsupported Delta partition column type {t!r} "
                    f"for column {c!r}")
            out[c] = t
        return out

    # -- datasource surface ----------------------------------------------
    def estimate_inmemory_data_size(self):
        return _parquet_size_estimate([p for p, _ in self._files])

    def get_read_tasks(self, parallelism: int) -> List["ReadTask"]:
        groups = [self._files[i::parallelism] for i in range(parallelism)]
        groups = [g for g in groups if g]
        out = []
        for g in groups:
            def read(items=tuple(g), cols=self._columns,
                     pschema=self._part_schema):
                pa = _require("pyarrow")
                pq = _require("pyarrow.parquet")

                for p, pvals in items:
                    file_cols = (None if cols is None else
                                 [c for c in cols if c not in pschema])
                    want_parts = [c for c in pschema
                                  if cols is None or c in cols]
                    if cols is not None and not file_cols and want_parts:
                        # partition-only projection: no parquet columns
                        # needed, just the row count
                        n = pq.ParquetFile(p).metadata.num_rows
                        yield from_arrow(pa.table({
                            c: _delta_partition_array(
                                pschema[c], pvals.get(c), n)
                            for c in want_parts}))
                        continue
                    # partitioning=None: the delta log's partitionValues
                    # are the source of truth — pyarrow would otherwise
                    # hive-infer day=... path segments as string columns,
                    # shadowing the schema-typed materialization below
                    tbl = pq.read_table(p, columns=file_cols,
                                        partitioning=None)
                    for c in want_parts:
                        # writers MAY also store partition columns in the
                        # data files; don't append a duplicate then
                        if c in tbl.column_names:
                            continue
                        tbl = tbl.append_column(c, _delta_partition_array(
                            pschema[c], pvals.get(c), tbl.num_rows))
                    yield from_arrow(tbl)
            out.append(ReadTask(read, BlockMetadata(
                num_rows=None, size_bytes=None, schema=None,
                input_files=[p for p, _ in g])))
        return out


def _parquet_fan_out(files: List[tuple], columns, parallelism: int
                     ) -> List["ReadTask"]:
    """Round-robin a known file list into parquet ReadTasks (shared by
    the table-format readers whose snapshots resolve to plain parquet
    file sets). ``files`` entries are (path, size_bytes, num_rows)
    tuples — table-format manifests carry exact per-file stats, so use
    them in block metadata instead of None/re-statting."""
    groups = [files[i::parallelism] for i in range(parallelism)]
    groups = [g for g in groups if g]
    out = []
    for g in groups:
        def read(paths=tuple(p for p, _, _ in g), cols=columns):
            pq = _require("pyarrow.parquet")

            for p in paths:
                yield from_arrow(pq.read_table(p, columns=cols))
        sizes = [s for _, s, _ in g]
        rows = [r for _, _, r in g]
        out.append(ReadTask(read, BlockMetadata(
            num_rows=sum(rows) if all(r is not None for r in rows)
            else None,
            size_bytes=sum(sizes) if all(s is not None for s in sizes)
            else None,
            schema=None, input_files=[p for p, _, _ in g])))
    return out


def _parquet_size_estimate(files: List[str],
                           sizes: Optional[List[Optional[int]]] = None
                           ) -> Optional[int]:
    """On-disk bytes * decode ratio; exact manifest sizes when the
    caller has them, getsize syscalls otherwise."""
    try:
        total = sum(s if (sizes and sizes[i] is not None)
                    else os.path.getsize(files[i])
                    for i, s in enumerate(sizes or [None] * len(files)))
        return int(total * 5.0)
    except OSError:
        return None


def _iceberg_local_path(uri: str, root: str) -> str:
    """Resolve a location recorded in Iceberg metadata to a local path.
    Writers record full URIs at write time; strip file:// and fall back
    to joining relative paths under the table root."""
    if uri.startswith("file://"):
        uri = uri[len("file://"):]
    if "://" in uri:
        raise ValueError(
            f"read_iceberg reads local filesystems (metadata references "
            f"{uri!r}); mount or sync the table locally")
    if os.path.isabs(uri):
        return uri
    return os.path.join(root, uri)


class IcebergDatasource(Datasource):
    """Apache Iceberg table reader (reference:
    _internal/datasource/iceberg_datasource.py delegates to pyiceberg;
    the format itself is open: JSON table metadata + Avro manifest
    lists/manifests + parquet data files, decoded with the in-tree Avro
    reader and pyarrow). Reconstructs a snapshot: current metadata file
    -> snapshot -> manifest list (Avro) -> manifests (Avro) -> live
    parquet data files (entry status != DELETED). ``snapshot_id``
    time-travels to any retained snapshot. Row-level deletes (v2
    position/equality delete files) and non-parquet data files are out
    of scope and refuse loudly."""

    def __init__(self, table_path: str,
                 columns: Optional[List[str]] = None,
                 snapshot_id: Optional[int] = None):
        if "://" in table_path and not table_path.startswith("file://"):
            raise ValueError(
                f"read_iceberg reads local filesystem tables (got "
                f"{table_path!r}); mount or sync the table locally, or "
                "export to parquet and use read_parquet")
        if table_path.startswith("file://"):
            table_path = table_path[len("file://"):]
        self._root = table_path.rstrip("/")
        self._columns = columns
        self._files = self._live_files(snapshot_id)

    def get_name(self):
        return "Iceberg"

    # -- metadata resolution ----------------------------------------------

    def _current_metadata(self) -> str:
        """Latest metadata JSON: trust metadata/version-hint.text when it
        resolves, else pick the highest version among *.metadata.json
        (covers both v<N>.metadata.json and <N>-<uuid>.metadata.json
        naming)."""
        import re

        md = os.path.join(self._root, "metadata")
        if not os.path.isdir(md):
            raise FileNotFoundError(
                f"{self._root} is not an Iceberg table (no metadata/ dir)")
        hint = os.path.join(md, "version-hint.text")
        if os.path.exists(hint):
            with open(hint) as f:
                v = f.read().strip()
            for name in (f"v{v}.metadata.json", f"{v}.metadata.json"):
                p = os.path.join(md, name)
                if os.path.exists(p):
                    return p
        best, best_v = None, -1
        pat = re.compile(r"^v?(\d+)")
        for name in os.listdir(md):
            if not name.endswith(".metadata.json"):
                continue
            m = pat.match(name)
            v = int(m.group(1)) if m else 0
            if v > best_v:
                best, best_v = name, v
        if best is None:
            raise FileNotFoundError(
                f"{md} contains no *.metadata.json files")
        return os.path.join(md, best)

    def _live_files(self, snapshot_id: Optional[int]) -> List[tuple]:
        """Returns (local path, size_bytes, record_count) per live data
        file, stats straight from the manifest entries."""
        import json

        with open(self._current_metadata()) as f:
            meta = json.load(f)
        fv = int(meta.get("format-version") or 1)
        if fv > 2:
            raise ValueError(
                f"unsupported Iceberg format-version {fv} (this reader "
                "implements v1/v2)")
        snapshots = meta.get("snapshots") or []
        if snapshot_id is None:
            snapshot_id = meta.get("current-snapshot-id")
        if snapshot_id is None or snapshot_id == -1 or not snapshots:
            return []  # empty table: no snapshot yet
        snap = next((s for s in snapshots
                     if s.get("snapshot-id") == snapshot_id), None)
        if snap is None:
            raise ValueError(
                f"snapshot {snapshot_id} not found in "
                f"{sorted(s.get('snapshot-id') for s in snapshots)}")

        manifests: List[str] = []
        live: List[tuple] = []  # (path, size_bytes, record_count)
        if snap.get("manifest-list"):
            for e in read_avro_rows(
                    _iceberg_local_path(snap["manifest-list"], self._root)):
                # v2 manifest lists mark delete manifests via content=1
                if int(e.get("content") or 0) != 0:
                    raise ValueError(
                        "unsupported Iceberg feature: row-level delete "
                        "manifests (merge-on-read v2 tables); compact/"
                        "rewrite the table to copy-on-write first")
                manifests.append(e["manifest_path"])
        else:
            # v1 inline manifest listing
            manifests = list(snap.get("manifests") or [])

        for mpath in manifests:
            for entry in read_avro_rows(
                    _iceberg_local_path(mpath, self._root)):
                if int(entry.get("status") or 0) == 2:  # DELETED
                    continue
                df = entry.get("data_file") or {}
                if int(df.get("content") or 0) != 0:
                    raise ValueError(
                        "unsupported Iceberg feature: delete files "
                        "(position/equality deletes)")
                fmt = (df.get("file_format") or "PARQUET").upper()
                if fmt != "PARQUET":
                    raise ValueError(
                        f"unsupported Iceberg data file format {fmt!r} "
                        "(parquet only)")
                live.append(
                    (_iceberg_local_path(df["file_path"], self._root),
                     df.get("file_size_in_bytes"),
                     df.get("record_count")))
        return live

    # -- datasource surface ----------------------------------------------

    def estimate_inmemory_data_size(self):
        return _parquet_size_estimate([p for p, _, _ in self._files],
                                      [s for _, s, _ in self._files])

    def get_read_tasks(self, parallelism: int) -> List["ReadTask"]:
        return _parquet_fan_out(self._files, self._columns, parallelism)


# ---- TFRecord writer: CRC-32C framing --------------------------------------

_CRC32C_FAST = None
_CRC32C_PROBED = False


def _crc32c_fast():
    """Best importable C implementation of CRC-32C, probed once: the
    crc32c or google-crc32c extensions if installed."""
    global _CRC32C_FAST, _CRC32C_PROBED
    if _CRC32C_PROBED:
        return _CRC32C_FAST
    _CRC32C_PROBED = True
    try:
        import crc32c as _c

        _CRC32C_FAST = _c.crc32c
        return _CRC32C_FAST
    except (ImportError, AttributeError):
        pass
    try:
        import google_crc32c as _g

        _CRC32C_FAST = _g.value
    except ImportError:
        _CRC32C_FAST = None
    return _CRC32C_FAST


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) — the TFRecord framing checksum. Uses a C
    extension when one is importable; the pure-python table loop is the
    dependency-free fallback (~MB/s — fine for tests and small writes,
    install crc32c for bulk exports)."""
    fast = _crc32c_fast()
    if fast is not None:
        return fast(data)
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


_CRC32C_TABLE: Optional[List[int]] = None


def _crc32c_table():
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        poly = 0x82F63B78
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tbl.append(c)
        _CRC32C_TABLE = tbl
    return _CRC32C_TABLE


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def write_tfrecords_file(records, path: str) -> int:
    """Write raw byte records in TFRecord framing WITH valid masked
    CRC-32C checksums (interoperable with TensorFlow readers; the
    in-repo reader skips checksum verification). Returns record count."""
    import struct

    n = 0
    with open(path, "wb") as f:
        for rec in records:
            rec = bytes(rec)
            header = struct.pack("<Q", len(rec))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc(rec)))
            n += 1
    return n


class HuggingFaceDatasource(FileDatasource):
    """Distributed reader for the HF ``datasets`` LOCAL on-disk format
    (``Dataset.save_to_disk``: arrow shard files + state.json listing
    them; DatasetDict adds one subdirectory per split). Shards split
    across read tasks, so a big saved dataset streams without the
    driver materializing it — unlike ``from_huggingface``, which
    converts an in-memory Dataset (reference:
    _internal/datasource/huggingface_datasource.py; no network or hub
    client needed for this path)."""

    suffixes = [".arrow"]

    def __init__(self, path, split: Optional[str] = None):
        import json

        path = os.path.abspath(os.fspath(path))
        if os.path.isdir(path):
            if os.path.exists(os.path.join(path, "dataset_dict.json")):
                splits = sorted(
                    d for d in os.listdir(path)
                    if os.path.exists(os.path.join(path, d, "state.json")))
                if split is None:
                    raise ValueError(
                        f"{path} holds a DatasetDict with splits "
                        f"{splits}; pass split=...")
                if split not in splits:
                    raise ValueError(
                        f"split {split!r} not in {splits} at {path}")
                path = os.path.join(path, split)
            state = os.path.join(path, "state.json")
            if os.path.exists(state):
                with open(state) as f:
                    files = [os.path.join(path, e["filename"])
                             for e in json.load(f)["_data_files"]]
                self._paths = files
                return
        super().__init__(path)

    def read_file(self, path: str):
        pa = _require("pyarrow")
        ipc = _require("pyarrow.ipc")

        # save_to_disk shards are Arrow STREAMING format; memory-map so
        # a shard larger than the block target still reads lazily
        with pa.memory_map(path) as source:
            try:
                reader = ipc.open_stream(source)
            except pa.ArrowInvalid:
                reader = ipc.open_file(source)  # the random-access variant
            for batch in reader:
                if batch.num_rows:
                    yield from_arrow(pa.Table.from_batches([batch]))
