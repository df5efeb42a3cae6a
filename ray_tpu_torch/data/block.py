"""Blocks: the unit of data in ray_tpu_torch.data.

The port's counterpart of ``ray_tpu/data/block.py``, whose block is a
``pyarrow.Table``. Here a block is a ``Table`` of the port's own: equal-
length numpy columns and a ``Schema``. The Data core, the device feed and
the Train ingest run on numpy alone, so they import on a machine without
pyarrow or pandas; the formats that are Arrow or pandas by nature
(``batch_format="pyarrow"`` / ``"pandas"``, ``from_arrow``, ``to_arrow``,
``from_pandas``, ``to_pandas``) import those packages when called.

Columns:

* numeric and bool columns are ``ndarray``s of shape ``(N,)``;
* tensor columns are ``ndarray``s of shape ``(N, *inner)``: the inner
  shape is the array's own (the reference keeps it in a FixedSizeList
  plus schema metadata);
* strings, bytes, ``None``, nested and ragged values live in ``object``
  columns, each tagged with the type Arrow would infer for its values
  (``string``, ``binary``, ``bool``, ``int64``, ``double``, ``null`` or
  ``object``), so a nullable number reads back as the reference's does:
  ``None`` in a row, ``NaN`` in a numpy batch.

Simple (untabular) rows are wrapped in a single ``item`` column, as the
reference does. A ``Table`` pickles as its numpy columns, so a large
block travels out of band through the object store and its ``get`` is a
view into the store.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

ITEM_COL = "item"

# the Arrow types of object columns; a column of any other dtype is typed
# by its numpy dtype
_NUMERIC_KINDS = {"bool": np.bool_, "int64": np.int64, "double": np.float64}


class Schema:
    """Column names, types and inner (tensor) shapes of a ``Table``."""

    def __init__(self, names: Sequence[str], types: Sequence[str],
                 shapes: Sequence[tuple]):
        self.names = list(names)
        self.types = list(types)
        self.shapes = [tuple(s) for s in shapes]

    def __eq__(self, other) -> bool:
        return (isinstance(other, Schema) and self.names == other.names
                and self.types == other.types
                and self.shapes == other.shapes)

    def __repr__(self) -> str:
        cols = ", ".join(
            f"{n}: {t}" + (f"{list(s)}" if s else "")
            for n, t, s in zip(self.names, self.types, self.shapes))
        return f"Schema({cols})"


def _kind_of(values: Sequence[Any]) -> str:
    """The Arrow type ``pa.array(values)`` would infer, for the types the
    block distinguishes."""
    kinds = set()
    for v in values:
        if v is None:
            continue
        if isinstance(v, (bool, np.bool_)):
            kinds.add("bool")
        elif isinstance(v, (int, np.integer)):
            kinds.add("int64")
        elif isinstance(v, (float, np.floating)):
            kinds.add("double")
        elif isinstance(v, str):
            kinds.add("string")
        elif isinstance(v, bytes):
            kinds.add("binary")
        else:
            return "object"
    if not kinds:
        return "null"
    if kinds == {"int64", "double"}:
        return "double"
    return kinds.pop() if len(kinds) == 1 else "object"


def _object_array(values: Sequence[Any]) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = list(values)
    return out


def _from_values(values: Sequence[Any]) -> tuple:
    """A column from Python values, as ``pa.array(values)`` types them:
    (array, kind). Numbers and bools without a ``None`` become typed
    numpy columns; everything else an object column tagged with its
    kind."""
    kind = _kind_of(values)
    if kind in _NUMERIC_KINDS and not any(v is None for v in values):
        return np.asarray(values, dtype=_NUMERIC_KINDS[kind]), None
    return _object_array(values), kind


def _column(v: Any) -> tuple:
    """A UDF's batch column as (array, kind): numpy as it is, strings and
    bytes as object columns, objects typed by their values."""
    arr = np.asarray(v)
    if arr.ndim == 0:
        arr = arr.reshape(1)
    if arr.dtype.kind in "US":
        return _object_array(arr.tolist()), ("string" if arr.dtype.kind == "U"
                                             else "binary")
    if arr.dtype == object:
        return _from_values(list(arr)) if arr.ndim == 1 else (arr, "object")
    return arr, None


def _py(v: Any) -> Any:
    """A cell as ``pyarrow``'s ``as_py`` gives it: numpy scalars as Python
    scalars, arrays as lists, containers converted inside."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _py(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_py(x) for x in v]
    return v


def _list_cell(v: Any) -> Any:
    if not isinstance(v, (list, tuple)):
        return v
    arr = np.asarray(v)
    return _object_array(list(v)) if arr.dtype.kind in "USO" else arr


def _read_only(arr: np.ndarray) -> np.ndarray:
    view = arr.view()
    view.flags.writeable = False
    return view


class Table:
    """Equal-length numpy columns: the port's block.

    ``columns`` maps names to arrays of one length; ``kinds`` tags object
    columns with their Arrow type (inferred when left out)."""

    __slots__ = ("_cols", "_kinds", "_num_rows")

    def __init__(self, columns: Optional[Dict[str, np.ndarray]] = None,
                 kinds: Optional[Dict[str, str]] = None,
                 num_rows: Optional[int] = None):
        self._cols: Dict[str, np.ndarray] = dict(columns or {})
        self._kinds: Dict[str, str] = {}
        lens = {len(a) for a in self._cols.values()}
        if len(lens) > 1:
            raise ValueError(
                f"columns of unequal length: "
                f"{ {k: len(a) for k, a in self._cols.items()} }")
        self._num_rows = lens.pop() if lens else (num_rows or 0)
        for k, a in self._cols.items():
            if a.dtype == object:
                kind = (kinds or {}).get(k)
                self._kinds[k] = kind if kind else (
                    _kind_of(a) if a.ndim == 1 else "object")

    # ---- the members the copied modules read off a block ----

    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def column_names(self) -> List[str]:
        return list(self._cols)

    @property
    def nbytes(self) -> int:
        total = 0
        for a in self._cols.values():
            if a.dtype != object:
                total += a.nbytes
                continue
            # Arrow's variable-width layout: an offset per cell plus the
            # payload of each string or bytes value
            total += 8 * len(a) + sum(
                len(v) for v in a if isinstance(v, (str, bytes)))
        return total

    @property
    def schema(self) -> Schema:
        names = list(self._cols)
        return Schema(
            names,
            [self._kinds.get(k) or self._cols[k].dtype.name for k in names],
            [self._cols[k].shape[1:] for k in names])

    def __len__(self) -> int:
        return self._num_rows

    def column(self, name: str) -> np.ndarray:
        return self._cols[name]

    def kind(self, name: str) -> Optional[str]:
        """The Arrow type of an object column, else None."""
        return self._kinds.get(name)

    def slice(self, offset: int = 0, length: Optional[int] = None) -> "Table":
        stop = self._num_rows if length is None else min(
            offset + length, self._num_rows)
        offset = min(offset, self._num_rows)
        return Table({k: a[offset:stop] for k, a in self._cols.items()},
                     self._kinds, num_rows=max(stop - offset, 0))

    def take(self, indices) -> "Table":
        idx = np.asarray(indices, dtype=np.int64)
        return Table({k: a[idx] for k, a in self._cols.items()},
                     self._kinds, num_rows=len(idx))

    def select(self, names: Sequence[str]) -> "Table":
        return Table({k: self._cols[k] for k in names},
                     {k: v for k, v in self._kinds.items() if k in names},
                     num_rows=self._num_rows)

    def drop(self, names: Sequence[str]) -> "Table":
        return self.select([k for k in self._cols if k not in names])

    def rename(self, mapping: Dict[str, str]) -> "Table":
        return Table({mapping.get(k, k): a for k, a in self._cols.items()},
                     {mapping.get(k, k): v for k, v in self._kinds.items()},
                     num_rows=self._num_rows)

    def append_column(self, name: str, column: np.ndarray,
                      kind: Optional[str] = None) -> "Table":
        cols = dict(self._cols)
        cols[name] = column
        kinds = dict(self._kinds)
        if kind:
            kinds[name] = kind
        return Table(cols, kinds, num_rows=self._num_rows)

    @staticmethod
    def concat(tables: Sequence["Table"]) -> "Table":
        """Row-wise concatenation; a column missing from some tables is
        filled with nulls (Arrow's default schema promotion)."""
        names: List[str] = []
        for t in tables:
            names += [k for k in t._cols if k not in names]
        n = sum(t.num_rows for t in tables)
        cols, kinds = {}, {}
        for k in names:
            parts = [t._cols.get(k) for t in tables]
            if all(p is not None and p.dtype != object for p in parts) and \
                    len({p.shape[1:] for p in parts}) == 1:
                cols[k] = np.concatenate(parts)
                continue
            values: List[Any] = []
            for t, p in zip(tables, parts):
                if p is None:
                    values += [None] * t.num_rows
                elif p.ndim > 1:
                    values += list(p)
                else:
                    values += p.tolist() if p.dtype != object else list(p)
            known = {t._kinds.get(k) for t in tables} - {None, "null"}
            if len(known) == 1 and all(
                    p is None or p.dtype == object for p in parts):
                cols[k], kinds[k] = _object_array(values), known.pop()
            else:
                cols[k], kinds[k] = _from_values(values)
                if kinds[k] is None:
                    del kinds[k]
        return Table(cols, kinds, num_rows=n)

    def to_pandas(self):
        return to_arrow(self).to_pandas()

    def __reduce__(self):
        return (_rebuild_table, (self._cols, self._kinds, self._num_rows))

    def __repr__(self) -> str:
        return f"Table({self._num_rows} rows, {self.schema!r})"


def _rebuild_table(cols, kinds, num_rows):
    return Table(cols, kinds, num_rows=num_rows)


# A Block is a Table; a Batch is what UDFs/iterators see.
Block = Table
Batch = Union[Table, Dict[str, np.ndarray], Any]


@dataclass
class BlockMetadata:
    """Sidecar metadata, kept small so the executor can plan without
    fetching block payloads (reference: BlockMetadata in data/block.py)."""

    num_rows: int
    size_bytes: int
    schema: Optional[Schema] = None
    input_files: Optional[List[str]] = None
    exec_stats: Optional[dict] = None


def _is_tabular_row(row: Any) -> bool:
    return isinstance(row, dict)


def _type_module(obj) -> str:
    return type(obj).__module__.split(".")[0]


class BlockAccessor:
    """Uniform view over a block (reference: BlockAccessor, block.py:221)."""

    def __init__(self, block: Block):
        if not isinstance(block, Table):
            raise TypeError(f"Block must be a Table, got {type(block)}")
        self._table = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    # ---- builders ----

    @staticmethod
    def batch_to_block(batch: Batch) -> Block:
        """Normalize a UDF return / input batch into a Table."""
        if isinstance(batch, Table):
            return batch
        if isinstance(batch, dict):
            cols, kinds = {}, {}
            for k, v in batch.items():
                cols[k], kind = _column(v)
                if kind:
                    kinds[k] = kind
            return Table(cols, kinds)
        mod = _type_module(batch)
        if mod == "pyarrow" and hasattr(batch, "column_names"):
            return from_arrow(batch)
        if mod == "pandas" and hasattr(batch, "columns"):
            return from_pandas(batch)
        raise TypeError(
            "Batches must be Table, pyarrow.Table, pandas.DataFrame, or "
            f"Dict[str, np.ndarray]; got {type(batch)}")

    @staticmethod
    def rows_to_block(rows: List[Any]) -> Block:
        if rows and all(_is_tabular_row(r) for r in rows):
            # Union of keys across rows, first-seen order; rows missing a
            # key contribute nulls (reference fills missing fields with
            # null rather than raising).
            keys = list(rows[0].keys())
            seen = set(keys)
            for r in rows[1:]:
                for k in r:
                    if k not in seen:
                        seen.add(k)
                        keys.append(k)
            cols, kinds = {}, {}
            for k in keys:
                vals = [r.get(k) for r in rows]
                if any(v is None for v in vals):
                    cols[k], kinds[k] = _from_values(vals)
                    continue
                try:
                    arr = np.asarray(vals)
                except ValueError:
                    arr = _object_array(vals)
                # object values, and str or bytes whose trailing NULs a
                # numpy U or S array would drop (the reference's rows lose
                # them), keep the values as they are
                if arr.dtype == object or arr.dtype.kind in "US":
                    cols[k], kinds[k] = _from_values(vals)
                else:
                    cols[k], kinds[k] = _column(arr)
            return Table(cols, {k: v for k, v in kinds.items() if v})
        col, kind = _from_values(rows)
        return Table({ITEM_COL: col}, {ITEM_COL: kind} if kind else None)

    # ---- views ----

    @property
    def table(self) -> Table:
        return self._table

    def num_rows(self) -> int:
        return self._table.num_rows

    def size_bytes(self) -> int:
        return self._table.nbytes

    def schema(self) -> Schema:
        return self._table.schema

    def get_metadata(self, input_files: Optional[List[str]] = None,
                     exec_stats: Optional[dict] = None) -> BlockMetadata:
        return BlockMetadata(
            num_rows=self.num_rows(),
            size_bytes=self.size_bytes(),
            schema=self.schema(),
            input_files=input_files,
            exec_stats=exec_stats,
        )

    def to_batch(self, batch_format: str) -> Batch:
        if batch_format in ("numpy", "default"):
            return self.to_numpy()
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format in ("pyarrow", "arrow"):
            return to_arrow(self._table)
        raise ValueError(f"Unknown batch_format {batch_format!r}")

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Columns as read-only arrays (Arrow's zero-copy ``to_numpy``
        gives read-only views too); a nullable number column as float64
        with NaN for nulls, as Arrow converts it."""
        out = {}
        t = self._table
        for name in t.column_names:
            arr = t.column(name)
            kind = t.kind(name)
            if kind in _NUMERIC_KINDS:
                # a slice may hold no null: then it is a typed column
                if not any(v is None for v in arr):
                    arr = np.asarray(list(arr), dtype=_NUMERIC_KINDS[kind])
                elif kind != "bool":
                    arr = np.asarray(
                        [np.nan if v is None else v for v in arr],
                        dtype=np.float64)
            elif kind == "object" and arr.ndim == 1:
                # a list cell reads as an array, as Arrow's list columns
                # convert
                arr = _object_array([_list_cell(v) for v in arr])
            out[name] = _read_only(arr)
        return out

    def to_pandas(self):
        return self._table.to_pandas()

    def _iter_dicts(self) -> Iterator[dict]:
        t = self._table
        names = t.column_names
        cells = []
        for name in names:
            arr = t.column(name)
            if arr.dtype == object:
                cells.append([_py(v) for v in arr])
            elif arr.ndim > 1:
                # tensor cells stay arrays of the column's dtype; copy so
                # row cells stay writable (store views are not)
                cells.append([a.copy() for a in arr])
            else:
                cells.append(arr.tolist())
        for i in range(t.num_rows):
            yield {n: c[i] for n, c in zip(names, cells)}

    def iter_rows(self) -> Iterator[Any]:
        t = self._table
        if t.column_names == [ITEM_COL]:
            for row in self._iter_dicts():
                yield row[ITEM_COL]
            return
        yield from self._iter_dicts()

    # ---- ops ----

    def slice(self, start: int, end: int) -> Block:
        return self._table.slice(start, end - start)

    def take_rows(self, indices: np.ndarray) -> Block:
        return self._table.take(indices)

    def select_columns(self, cols: List[str]) -> Block:
        return self._table.select(cols)

    def drop_columns(self, cols: List[str]) -> Block:
        return self._table.drop(cols)

    def rename_columns(self, mapping: Dict[str, str]) -> Block:
        return self._table.rename(mapping)

    def sort_indices(self, key: Union[str, List[str]],
                     descending: bool = False) -> np.ndarray:
        """A stable sort by ``key`` (first key primary), each key in the
        given order, as Arrow's ``sort_indices``."""
        keys = [key] if isinstance(key, str) else list(key)
        ranks = []
        for k in keys:
            _, rank = np.unique(self._table.column(k), return_inverse=True)
            rank = rank.reshape(-1)
            ranks.append(-rank if descending else rank)
        return np.lexsort(ranks[::-1])

    @staticmethod
    def concat(blocks: List[Block]) -> Block:
        blocks = [b for b in blocks if b.num_rows > 0]
        if not blocks:
            return Table({})
        if len(blocks) == 1:
            return blocks[0]
        return Table.concat(blocks)

    def random_shuffle_indices(self, seed: Optional[int]) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.permutation(self.num_rows())


# ---- Arrow and pandas interop (imported when called) -----------------------

def _require(module: str):
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError:
        raise ImportError(
            f"this format needs {module.split('.')[0]!r}, which is not "
            "installed; the numpy formats (batch_format='numpy', "
            "read_numpy, write_numpy, write_json) need nothing else"
        ) from None


def to_arrow(table: Table):
    """A ``pyarrow.Table`` laid out as the reference's block: tensor
    columns as FixedSizeLists with their inner shape in the schema
    metadata (``tensor_shape:<col>``), so files the port writes read back
    alike in both packages."""
    pa = _require("pyarrow")
    cols, meta = {}, {}
    for name in table.column_names:
        arr = table.column(name)
        if arr.dtype == object:
            cols[name] = pa.array(list(arr))
        elif arr.ndim > 1:
            flat = np.ascontiguousarray(arr).reshape(len(arr), -1)
            cols[name] = pa.FixedSizeListArray.from_arrays(
                pa.array(flat.reshape(-1)), flat.shape[1])
            meta[f"tensor_shape:{name}".encode()] = \
                repr(tuple(arr.shape[1:])).encode()
        else:
            cols[name] = pa.array(arr)
    out = pa.table(cols) if cols else pa.table({})
    if meta:
        out = out.replace_schema_metadata(meta)
    return out


def from_arrow(pa_table) -> Table:
    """A ``Table`` from a ``pyarrow.Table``, read as the reference reads
    its block: FixedSizeLists (reshaped by ``tensor_shape:`` metadata)
    as tensor columns, other lists as object columns of arrays, nulls as
    ``None``."""
    import ast

    pa = _require("pyarrow")
    meta = pa_table.schema.metadata or {}
    cols, kinds = {}, {}
    for name in pa_table.column_names:
        col = pa_table.column(name)
        typ = col.type
        if pa.types.is_fixed_size_list(typ):
            combined = col.combine_chunks() if col.num_chunks else \
                pa.array([], type=typ)
            values = combined.values.to_numpy(zero_copy_only=False)
            arr = values.reshape(len(combined), typ.list_size)
            key = f"tensor_shape:{name}".encode()
            if key in meta:
                arr = arr.reshape((len(arr),) + tuple(
                    ast.literal_eval(meta[key].decode())))
            cols[name] = arr
        elif pa.types.is_list(typ) or pa.types.is_large_list(typ):
            cols[name] = _object_array(list(col.to_numpy(
                zero_copy_only=False)))
            kinds[name] = "object"
        elif col.null_count == 0 and (
                pa.types.is_integer(typ) or pa.types.is_floating(typ)
                or pa.types.is_boolean(typ) or pa.types.is_temporal(typ)):
            cols[name] = col.to_numpy()
        else:
            cols[name], kind = _from_values(col.to_pylist())
            if kind == "null":
                # every value null: the column's Arrow type names its kind
                # (an all-null int column converts to NaNs, as Arrow's)
                kind = ("int64" if pa.types.is_integer(typ) else
                        "double" if pa.types.is_floating(typ) else
                        "bool" if pa.types.is_boolean(typ) else kind)
            if kind:
                kinds[name] = kind
            elif pa.types.is_null(typ):
                kinds[name] = "null"
    return Table(cols, kinds, num_rows=pa_table.num_rows)


def from_pandas(df) -> Table:
    pa = _require("pyarrow")
    return from_arrow(pa.Table.from_pandas(df, preserve_index=False))
