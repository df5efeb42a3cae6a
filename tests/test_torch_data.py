"""The port's Data library (``ray_tpu_torch.data``) against ``ray_tpu.data``.

Each program of ``tests/test_data.py`` and ``tests/test_streaming.py``
that a ported datasource can run goes through both packages in this
process, each on its own runtime (4 workers), and the two results must
be equal: rows and batches exactly (dtypes and shapes included), float64
aggregates at rtol 1e-12, and error cases by exception type name. The
port's block is its own numpy ``Table``, the reference's a
``pyarrow.Table``; the port-only cases check the block's Python types
against Arrow's ``to_pylist``, that a 64 MiB block's ``get`` is a view
into the shm store, that ``import ray_tpu_torch.data`` loads none of
torch, pyarrow and pandas, and that ``__all__`` is the reference's plus
``Schema`` and ``Table``. The readers' programs include those of
``tests/test_data.py`` (TFRecords, WebDataset, SQL, images, Avro,
HuggingFace, Delta, Iceberg), and BigQuery runs against a fake client
module.
"""

import ctypes
import importlib
import itertools
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import ray_tpu
import ray_tpu.data as ref_data
import ray_tpu_torch
import ray_tpu_torch.data as port_data

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def pkgs():
    ray_tpu.init(num_workers=4, object_store_memory=256 << 20)
    ray_tpu_torch.init(num_workers=4, object_store_memory=256 << 20)
    try:
        yield {"ref": (ray_tpu, ref_data), "port": (ray_tpu_torch, port_data)}
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


def _mod(rd, name):
    return importlib.import_module(f"{rd.__name__}.{name}")


def _norm(x):
    """A comparable form: arrays keep dtype and shape, numpy scalars
    become Python, NaN a marker."""
    if isinstance(x, np.ndarray):
        if x.dtype == object:
            return ("object", list(x.shape), [_norm(v) for v in x.tolist()])
        return (x.dtype.str, list(x.shape), _norm(x.tolist()))
    if isinstance(x, np.generic):
        return _norm(x.item())
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if type(x).__module__.startswith("torch"):
        return ("torch", str(x.dtype), _norm(x.numpy()))
    return x


def _close(a, b, rtol):
    if isinstance(a, float) and isinstance(b, float):
        return a == b or abs(a - b) <= rtol * max(abs(a), abs(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], rtol)
                                            for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_close(x, y, rtol)
                                        for x, y in zip(a, b))
    return a == b


PROGRAMS = {}


def program(rtol=0.0):
    def deco(fn):
        fn.rtol = rtol
        PROGRAMS[fn.__name__] = fn
        return fn
    return deco


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - compared by type name
        return ("raises", type(e).__name__)
    return ("returned",)


def _consume_splits(its, fn):
    outs = [None] * len(its)

    def run(i):
        outs[i] = fn(i)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(its))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts), "a split consumer hung"
    return outs


# --------------------------------------------------------------- programs
# each takes (runtime package, data package, temporary directory)


@program()
def range_count_take(rt, rd, tmp):
    ds = rd.range(100)
    return ds.count(), ds.take(5)


@program()
def from_items_simple_rows(rt, rd, tmp):
    return rd.from_items([1, 2, 3]).take_all()


@program()
def map_batches_numpy(rt, rd, tmp):
    return rd.range(64).map_batches(lambda b: {"id": b["id"] * 2}).take_all()


@program()
def map_rows_filter_flat_map(rt, rd, tmp):
    return (rd.range(20)
            .map(lambda r: {"v": r["id"] + 1})
            .filter(lambda r: r["v"] % 2 == 0)
            .flat_map(lambda r: [{"v": r["v"]}, {"v": -r["v"]}])).take_all()


@program()
def fusion_one_task_per_block(rt, rd, tmp):
    ds = (rd.range(32, parallelism=4)
          .map_batches(lambda b: {"id": b["id"] + 1})
          .map_batches(lambda b: {"id": b["id"] * 3}))
    bundles = list(ds._execute_bundles())
    return [b.num_rows for b in bundles], "->" in ds.stats()


@program()
def limit_short_circuits(rt, rd, tmp):
    return rd.range(10_000, parallelism=32).limit(10).take_all()


@program()
def sort_rows(rt, rd, tmp):
    return rd.from_items([{"k": i % 7, "v": i} for i in range(50)]) \
        .sort("k").take_all()


@program()
def sort_descending(rt, rd, tmp):
    return rd.range(40).sort("id", descending=True).take_all()


@program()
def sort_two_keys_blocks(rt, rd, tmp):
    items = [{"a": i % 3, "b": (i * 7) % 5, "s": f"s{i % 4}"}
             for i in range(60)]
    ds = rd.from_items(items, parallelism=3)
    return (ds.sort(["a", "b"]).take_all(),
            ds.sort("s", descending=True).take_all())


@program()
def random_shuffle_seeded(rt, rd, tmp):
    return rd.range(100, parallelism=4).random_shuffle(seed=7).take_all()


@program()
def repartition(rt, rd, tmp):
    ds = rd.range(100, parallelism=2).repartition(5)
    return [b.num_rows for b in ds._execute_bundles()], ds.take_all()


@program(rtol=1e-12)
def groupby_aggregates(rt, rd, tmp):
    rng = np.random.default_rng(0)
    items = [{"k": int(i % 3), "s": f"key{i % 5}", "v": int(i),
              "f": float(rng.normal(3.0, 2.0))} for i in range(90)]
    ds = rd.from_items(items, parallelism=4)
    g = ds.groupby("k")

    def rows(agg, *keys):
        # Arrow's hash group-by over a chunked table does not promise
        # first-appearance order: the groups are compared sorted by key
        return sorted(agg.take_all(), key=lambda r: [r[k] for k in keys])

    return (rows(g.sum("v"), "k"), rows(g.count(), "k"),
            rows(g.min("f"), "k"), rows(g.max("v"), "k"),
            rows(g.mean(["v", "f"]), "k"), rows(g.std("f"), "k"),
            rows(ds.groupby(["s", "k"]).sum("f"), "s", "k"),
            rows(ds.groupby("s").aggregate(rd.Sum("v"), rd.Mean("f"),
                                           rd.Count("v")), "s"))


@program(rtol=1e-12)
def global_aggregates(rt, rd, tmp):
    ds = rd.range(10)
    fl = rd.from_items([{"x": float(x)} for x in np.linspace(-3, 7, 41)])
    return (ds.groupby(None).aggregate(rd.Sum("id")).take_all(),
            ds.groupby(None).aggregate(rd.Mean("id"), rd.Max("id"),
                                       rd.Std("id")).take_all(),
            ds.sum("id"), ds.min("id"), ds.max("id"), ds.mean("id"),
            ds.std("id"), fl.std("x"), fl.mean("x"))


@program()
def map_groups(rt, rd, tmp):
    ds = rd.from_items([{"k": i % 4, "v": float(i)} for i in range(40)])

    def norm(batch):
        return {"k": batch["k"][:1], "mean": [batch["v"].mean()]}

    return ds.groupby("k").map_groups(norm).take_all()


@program()
def union_and_zip(rt, rd, tmp):
    a = rd.range(10)
    b = rd.range(10).map_batches(lambda x: {"id2": x["id"] + 100})
    return a.union(rd.range(5)).count(), a.zip(b).take_all(), \
        a.zip(a).take(3)


@program()
def actor_pool_callable_class(rt, rd, tmp):
    class AddConst:
        def __init__(self, c):
            self.c = c

        def __call__(self, batch):
            return {"id": batch["id"] + self.c}

    return rd.range(40, parallelism=4).map_batches(
        AddConst, concurrency=2, fn_constructor_args=(5,)).take_all()


@program()
def parquet_roundtrip(rt, rd, tmp):
    ds = rd.range(100).map_batches(
        lambda b: {"id": b["id"], "sq": b["id"] ** 2,
                   "t": np.stack([b["id"], -b["id"]], 1)
                   .reshape(-1, 1, 2).astype(np.float32)})
    paths = ds.write_parquet(str(tmp / "pq"))
    back = rd.read_parquet(str(tmp / "pq"))
    return (len(paths), sorted(back.take_all(), key=lambda r: r["id"]),
            back.take_batch(3))


@program()
def csv_and_json_roundtrip(rt, rd, tmp):
    ds = rd.from_items([{"a": i, "b": f"s{i}", "c": i / 4}
                        for i in range(10)])
    ds.write_csv(str(tmp / "csv"))
    csv_rows = sorted(rd.read_csv(str(tmp / "csv")).take_all(),
                      key=lambda r: r["a"])
    ds.write_json(str(tmp / "js"))
    js_rows = sorted(rd.read_json(str(tmp / "js")).take_all(),
                     key=lambda r: r["a"])
    return csv_rows, js_rows


@program()
def numpy_write_and_read(rt, rd, tmp):
    arr = np.arange(60, dtype=np.float32).reshape(10, 3, 2)
    rd.from_numpy(arr).write_numpy(str(tmp / "npy"))
    back = rd.read_numpy(str(tmp / "npy"))
    return back.take_batch(10), back.count()


@program()
def read_text_binary(rt, rd, tmp):
    p = tmp / "f.txt"
    p.write_text("alpha\nbeta\ngamma\n")
    rows = rd.read_text(str(p)).take_all()
    row = rd.read_binary_files(str(p)).take_all()[0]
    return rows, row["bytes"], row["path"] == str(p)


@program()
def iter_batches_sizes_and_formats(rt, rd, tmp):
    ds = rd.range(100, parallelism=3)
    batches = list(ds.iter_batches(batch_size=32, batch_format="numpy",
                                   prefetch_batches=0))
    pdf = next(iter(ds.iter_batches(batch_size=10, batch_format="pandas",
                                    prefetch_batches=0)))
    tbl = next(iter(ds.iter_batches(batch_size=10, batch_format="pyarrow",
                                    prefetch_batches=0)))
    return (batches, list(pdf.columns), pdf["id"].tolist(), tbl.num_rows,
            tbl.column_names, tbl.column("id").to_pylist())


@program()
def iter_batches_drop_last_and_prefetch(rt, rd, tmp):
    return list(rd.range(100).iter_batches(batch_size=32, drop_last=True,
                                           prefetch_batches=2))


@program()
def local_shuffle_buffer(rt, rd, tmp):
    ds = rd.range(64, parallelism=2)
    return list(ds.iter_batches(batch_size=64, prefetch_batches=0,
                                local_shuffle_buffer_size=64,
                                local_shuffle_seed=3))


@program()
def tensor_blocks_roundtrip(rt, rd, tmp):
    arr = np.arange(24, dtype=np.float32).reshape(6, 2, 2)
    ds = rd.from_numpy(arr)
    return ds.take_batch(6, batch_format="numpy"), ds.take(2), \
        rd.range_tensor(6, shape=(2, 3)).take_batch(6)


@program()
def add_drop_select_rename_columns(rt, rd, tmp):
    ds = rd.range(10).add_column("double", lambda b: b["id"] * 2)
    return (ds.take_all(), ds.select_columns(["double"]).columns(),
            ds.drop_columns(["double"]).columns(),
            ds.rename_columns({"id": "idx"}).columns())


@program()
def schema_names(rt, rd, tmp):
    return list(rd.range(50).schema().names), rd.range(50).count()


@program()
def split_materialized(rt, rd, tmp):
    parts = rd.range(100, parallelism=10).split(3, equal=True)
    return [p.count() for p in parts], [p.take_all() for p in parts]


@program()
def streaming_split_two_consumers(rt, rd, tmp):
    its = rd.range(80, parallelism=8).streaming_split(2)
    outs = _consume_splits(its, lambda i: [r["id"]
                                           for r in its[i].iter_rows()])
    return sorted(outs[0] + outs[1]), all(outs)


@program()
def random_sample_seeded(rt, rd, tmp):
    return (rd.range(1000).random_sample(0.1, seed=0).take_all(),
            rd.range(1000, parallelism=8).random_sample(0.5, seed=1)
            .take_all())


@program()
def stats_populated(rt, rd, tmp):
    ds = rd.range(10).map_batches(lambda b: b)
    rows = ds.take_all()
    return rows, "Dataset execution" in ds.stats()


@program()
def limit_then_map_terminates(rt, rd, tmp):
    return (rd.range(10_000, parallelism=32).limit(10)
            .map_batches(lambda b: {"id": b["id"] + 1})).take_all()


@program()
def heterogeneous_row_keys_fill_null(rt, rd, tmp):
    ds = rd.from_items([1, 2, 3, 4], parallelism=1).map(
        lambda r: {"v": r} if r % 2 else {"v": r, "extra": r * 10})
    return ds.take_all(), ds.take_batch(4)


@program()
def nulls_strings_and_nested_rows(rt, rd, tmp):
    items = [{"i": 1, "f": 0.5, "s": "a", "b": True, "l": [1, 2]},
             {"i": None, "f": None, "s": None, "b": None, "l": None},
             {"i": 3, "f": 2.5, "s": "c", "b": False, "l": [3]}]
    ds = rd.from_items(items, parallelism=1)
    return ds.take_all(), ds.take_batch(3), \
        ds.map_batches(lambda b: b).take_all()


@program()
def iterator_early_abandon_cleans_up(rt, rd, tmp):
    prefix = "rtpt" if rd.__name__.startswith("ray_tpu_torch") else "rtpu"
    name = f"{prefix}-data-prefetch"
    before = {th.name for th in threading.enumerate()}
    it = rd.range(10_000, parallelism=16).map_batches(lambda b: b) \
        .iter_batches(batch_size=100, prefetch_batches=2)
    first = next(it)
    it.close()
    deadline = time.time() + 10
    while time.time() < deadline:
        now = {th.name for th in threading.enumerate()
               if th.name.startswith(name)}
        if not (now - before):
            break
        time.sleep(0.05)
    return first, sorted(now - before)


@program()
def streaming_split_equal_exact_rows(rt, rd, tmp):
    its = rd.range(91, parallelism=7).streaming_split(2, equal=True)
    outs = _consume_splits(its, lambda i: [r["id"]
                                           for r in its[i].iter_rows()])
    return [len(o) for o in outs], bool(set(outs[0]) & set(outs[1]))


@program()
def streaming_split_multi_epoch(rt, rd, tmp):
    its = rd.range(40, parallelism=4).streaming_split(2, equal=True)
    return _consume_splits(
        its, lambda i: [sum(1 for _ in its[i].iter_rows())
                        for _ in range(2)])


@program()
def rename_columns_preserves_tensor_shape(rt, rd, tmp):
    img = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    ds = rd.from_items([{"img": img[i]} for i in range(2)])
    return next(iter(ds.rename_columns({"img": "image"}).iter_batches(
        batch_size=2, batch_format="numpy")))


@program()
def map_batches_concurrency_cap(rt, rd, tmp):
    TaskPoolMapOperator = _mod(rd, "physical").TaskPoolMapOperator
    Planner = _mod(rd, "planner").Planner
    ds = rd.range(64, parallelism=8).map_batches(lambda b: b, concurrency=2)
    topo = Planner(ds._context).plan(ds._logical_op)
    ops = [op for op in topo.ops if isinstance(op, TaskPoolMapOperator)]
    op = ops[0]
    op.input_queue.extend([None] * 5)
    op.pending = {object(): None, object(): None}
    return [o._max_concurrency for o in ops], op.can_launch(max_in_flight=8)


@program()
def streaming_split_error_propagates(rt, rd, tmp):
    def boom(b):
        raise ValueError("udf exploded")

    its = rd.range(40, parallelism=4).map_batches(boom) \
        .streaming_split(1, equal=True)
    try:
        for _ in its[0].iter_rows():
            pass
    except Exception as e:  # noqa: BLE001
        msg = str(e)
        return type(e).__name__, ("udf exploded" in msg
                                  or "pipeline failed" in msg)
    return "returned"


@program()
def streaming_split_abandoned_epoch_recovers(rt, rd, tmp):
    its = rd.range(200, parallelism=20).streaming_split(2, equal=True)
    return _consume_splits(its, lambda i: [
        len(list(itertools.islice(its[i].iter_rows(), 3))),
        sum(1 for _ in its[i].iter_rows())])


@program()
def streaming_split_sequential(rt, rd, tmp):
    its = rd.range(40, parallelism=4).streaming_split(2, equal=True)
    small = [sum(1 for _ in it.iter_rows()) for it in its]
    its = rd.range(400, parallelism=40).streaming_split(2, equal=True)
    return small, [sum(1 for _ in it.iter_rows()) for it in its]


@program()
def concurrency_zero_and_filter_refusals(rt, rd, tmp):
    return (_raises(lambda: rd.range(10).map_batches(lambda b: b,
                                                      concurrency=0)),
            _raises(lambda: rd.range(5).filter()),
            _raises(lambda: rd.range(10).map_batches(
                lambda b: b, **{_gpu_kw(rd): 1},
                compute=rd.TaskPoolStrategy(2))))


def _gpu_kw(rd):
    return "num_gpus" if rd.__name__.startswith("ray_tpu_torch") \
        else "num_chips"


@program()
def optimizer_merges_and_pushes_limits(rt, rd, tmp):
    L = _mod(rd, "logical")
    m = L.AbstractMap("Map", L.InputData([]), "map_rows", lambda r: r)
    lim1 = L.Limit(m, 10)
    lim2 = L.Limit(lim1, 5)
    root = _mod(rd, "optimizer").LogicalOptimizer().optimize(lim2)
    return (type(root).__name__, type(root.inputs[0]).__name__,
            root.inputs[0].limit,
            type(root.inputs[0].inputs[0]).__name__,
            lim2.inputs[0] is lim1 and lim1.inputs[0] is m)


@program()
def optimizer_pipelines(rt, rd, tmp):
    out = rd.range(1000, parallelism=8).map(
        lambda r: {"id": r["id"] * 2}).limit(7).take_all()
    base = rd.range(20, parallelism=4).map(lambda r: {"id": r["id"] * 2})
    lim = base.limit(5)
    diamond = rd.range(100, parallelism=4).map(lambda r: {"id": r["id"]})
    return (out, lim.take_all(), lim.take_all(), len(base.take_all()),
            diamond.union(diamond.limit(5)).count())


@program()
def actor_pool_scales_down(rt, rd, tmp):
    class AddOne:
        def __call__(self, batch):
            return {"id": [x + 1 for x in batch["id"]]}

    ds = rd.range(200, parallelism=16).map_batches(
        AddOne, compute=rd.ActorPoolStrategy(min_size=1, max_size=3))
    return sum(r["id"] for r in ds.iter_rows())


@program()
def from_torch(rt, rd, tmp):
    import torch
    from torch.utils.data import TensorDataset

    xs = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    ys = torch.arange(10)
    return rd.from_torch(TensorDataset(xs, ys), parallelism=2).take_all()


@program()
def cloud_readers_are_gated(rt, rd, tmp):
    out = []
    for call in (lambda: rd.read_lance("s3://bucket/path"),
                 lambda: rd.read_mongo("mongodb://h/db")):
        try:
            call()
        except ImportError as e:
            out.append(str(e))
    # read_delta is a real reader: a remote scheme refuses with an
    # actionable ValueError, not a gated ImportError
    try:
        rd.read_delta("s3://bucket/table")
    except ValueError as e:
        out.append(("ValueError", str(e)))
    return out


# ---- the deferred readers (programs of tests/test_data.py) ----


def _rows_by(ds, key):
    return sorted(ds.take_all(), key=lambda r: r[key])


@program()
def read_webdataset(rt, rd, tmp):
    import io
    import tarfile

    tar_path = str(tmp / "shard-000.tar")
    with tarfile.open(tar_path, "w") as tf:
        for i in range(3):
            # sample 1 has no .cls member: a null in that column
            for ext, payload in (("txt", f"caption {i}".encode()),
                                 ("cls", str(i).encode())):
                if (i, ext) == (1, "cls"):
                    continue
                info = tarfile.TarInfo(f"sample{i:04d}.{ext}")
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
    ds = rd.read_webdataset(tar_path)
    return ds.take_all(), ds.take_batch(3), ds.schema().names


@program()
def read_sql(rt, rd, tmp):
    import sqlite3

    db = str(tmp / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE t (id INTEGER, name TEXT)")
    conn.executemany("INSERT INTO t VALUES (?, ?)",
                     [(i, f"n{i}") for i in range(10)])
    conn.commit()
    conn.close()
    ds = rd.read_sql("SELECT id, name FROM t WHERE id >= 5",
                     lambda: sqlite3.connect(db))
    return _rows_by(ds, "id"), ds.take_batch(5)


@program()
def read_sql_column_types(rt, rd, tmp):
    """Arrow's inference from the cursor's Python values: int64, double,
    an int mixed with a float as double, a column of NULLs as null, a
    nullable int, text and blobs; 10,000-row pages."""
    import sqlite3

    db = str(tmp / "types.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE t (i INTEGER, f REAL, m NUMERIC, n TEXT, "
                 "ni INTEGER, s TEXT, b BLOB)")
    conn.executemany(
        "INSERT INTO t VALUES (?, ?, ?, ?, ?, ?, ?)",
        [(i, i / 8, i if i % 2 else i + 0.5, None,
          None if i % 3 == 0 else i, f"s{i}", bytes([i % 256, 7]))
         for i in range(10_050)])
    conn.commit()
    conn.close()
    ds = rd.read_sql("SELECT * FROM t ORDER BY i",
                     lambda: sqlite3.connect(db))
    batches = [b for b in ds.iter_batches(batch_size=None,
                                          prefetch_batches=0)]
    return ([len(b["i"]) for b in batches], batches[-1],
            ds.take(4), ds.schema().names)


@program()
def read_images_roundtrip(rt, rd, tmp):
    from PIL import Image

    rng = np.random.default_rng(0)
    for i in range(4):
        arr = rng.integers(0, 255, size=(10 + i, 12, 3), dtype=np.uint8)
        Image.fromarray(arr).save(tmp / f"img{i}.png")
    ds = rd.read_images(str(tmp), size=(8, 8), mode="RGB", parallelism=2)
    rows = [(os.path.basename(r["path"]), r["image"])
            for r in ds.take_all()]
    batch = ds.map_batches(lambda b: {"image": b["image"]}).take_batch(4)
    return sorted(rows, key=lambda r: r[0]), batch["image"].shape, \
        batch["image"].dtype.str


def _avro_rows():
    return [
        {"id": 1, "name": "a", "score": 0.5, "tag": "x"},
        {"id": -3, "name": "bb", "score": -2.25, "tag": None},
        {"id": 1 << 40, "name": "", "score": 0.0, "tag": "yy"},
    ]


@program()
def read_avro_null_codec(rt, rd, tmp):
    from tests.test_data import _avro_write

    _avro_write(tmp / "t.avro", _avro_rows(), codec=b"null")
    ds = rd.read_avro(str(tmp / "t.avro"))
    return ds.take_all(), ds.take_batch(3)


@program()
def read_avro_deflate_codec(rt, rd, tmp):
    from tests.test_data import _avro_write

    _avro_write(tmp / "t.avro", _avro_rows(), codec=b"deflate")
    ds = rd.read_avro(str(tmp / "t.avro"))
    return ds.take_all(), ds.take_batch(3)


@program()
def from_huggingface(rt, rd, tmp):
    import datasets as hfd

    hf = hfd.Dataset.from_dict(
        {"text": [f"t{i}" for i in range(12)],
         "label": list(range(12))})
    ds = rd.from_huggingface(hf, parallelism=4)
    sub = rd.from_huggingface(hf.select([5, 1, 7]), parallelism=2)
    return (ds.count(), _rows_by(ds, "label"), ds.take_batch(5),
            ds.map_batches(lambda b: {"label2": b["label"] * 2})
            .sum("label2"), sub.take_all())


@program()
def read_huggingface_local_format(rt, rd, tmp):
    import datasets as hfds

    d = hfds.Dataset.from_dict({"a": list(range(100)),
                                "b": [f"s{i}" for i in range(100)]})
    d.save_to_disk(str(tmp / "flat"), num_shards=3)
    rows = _rows_by(rd.read_huggingface(str(tmp / "flat")), "a")
    dd = hfds.DatasetDict({"train": d.select(range(80)),
                           "test": d.select(range(80, 100))})
    dd.save_to_disk(str(tmp / "dict"))
    test = rd.read_huggingface(str(tmp / "dict"), split="test")
    return (rows, test.count(), _rows_by(test, "a")[:3],
            _raises(lambda: rd.read_huggingface(str(tmp / "dict"))),
            _raises(lambda: rd.read_huggingface(str(tmp / "dict"),
                                                split="nope")))


@program()
def read_delta_log_replay(rt, rd, tmp):
    from tests.test_data import _write_delta_table

    _write_delta_table(str(tmp / "t1"))
    rows = _rows_by(rd.read_delta(str(tmp / "t1")), "x")
    proj = _rows_by(rd.read_delta(str(tmp / "t1"), columns=["x"]), "x")
    _write_delta_table(str(tmp / "t2"), with_checkpoint=True)
    rows2 = _rows_by(rd.read_delta(str(tmp / "t2")), "x")
    log = str(tmp / "t1" / "_delta_log")
    with open(os.path.join(log, f"{2:020d}.json"), "w") as f:
        f.write(json.dumps({"add": {"path": "f1.parquet",
                                    "deletionVector": {"x": 1}}}) + "\n")
    return rows, proj, rows2, _raises(
        lambda: rd.read_delta(str(tmp / "t1")).take_all())


def _delta_partitioned(tmp):
    import pyarrow as pa
    import pyarrow.parquet as pq

    root = str(tmp / "pt")
    log = os.path.join(root, "_delta_log")
    os.makedirs(log)
    schema = {"type": "struct", "fields": [
        {"name": "x", "type": "long", "nullable": True, "metadata": {}},
        {"name": "day", "type": "date", "nullable": True, "metadata": {}},
        {"name": "bucket", "type": "integer", "nullable": True,
         "metadata": {}},
    ]}
    for i, day in enumerate(["2026-07-01", "2026-07-02"]):
        d = os.path.join(root, f"day={day}")
        os.makedirs(d, exist_ok=True)
        pq.write_table(pa.table({"x": list(range(i * 5, i * 5 + 5))}),
                       os.path.join(d, "part.parquet"))
    with open(os.path.join(log, f"{0:020d}.json"), "w") as f:
        f.write(json.dumps({"metaData": {
            "id": "t", "configuration": {},
            "partitionColumns": ["day", "bucket"],
            "schemaString": json.dumps(schema)}}) + "\n")
        for i, day in enumerate(["2026-07-01", "2026-07-02"]):
            f.write(json.dumps({"add": {
                "path": f"day={day}/part.parquet", "size": 1,
                "dataChange": True,
                "partitionValues": {"day": day,
                                    "bucket": str(i) if i else None},
            }}) + "\n")
    return root


@program()
def read_delta_partitioned(rt, rd, tmp):
    root = _delta_partitioned(tmp)
    one_task = rd.read_delta(root, parallelism=1)
    return (_rows_by(rd.read_delta(root), "x"),
            _rows_by(rd.read_delta(root, columns=["x", "day"]), "x"),
            sorted(r["day"] for r in
                   rd.read_delta(root, columns=["day"]).take_all()),
            [b for b in one_task.iter_batches(batch_size=None,
                                              prefetch_batches=0)])


@program()
def read_delta_checkpoint_without_hint(rt, rd, tmp):
    from tests.test_data import _write_delta_table

    root = str(tmp / "t3")
    _write_delta_table(root, with_checkpoint=True)
    os.remove(os.path.join(root, "_delta_log", "_last_checkpoint"))
    os.remove(os.path.join(root, "_delta_log", f"{0:020d}.json"))
    return _rows_by(rd.read_delta(root), "x")


@program()
def read_delta_checkpoint_map_types(rt, rd, tmp):
    import pyarrow as pa
    import pyarrow.parquet as pq

    root = str(tmp / "t4")
    log = os.path.join(root, "_delta_log")
    os.makedirs(log)
    d = os.path.join(root, "day=2026-07-01")
    os.makedirs(d)
    pq.write_table(pa.table({"x": list(range(7))}),
                   os.path.join(d, "part.parquet"))
    smap = pa.map_(pa.string(), pa.string())
    schema_str = json.dumps({"type": "struct", "fields": [
        {"name": "x", "type": "long", "nullable": True, "metadata": {}},
        {"name": "day", "type": "date", "nullable": True, "metadata": {}}]})
    add_t = pa.struct([("path", pa.string()),
                       ("partitionValues", smap)])
    md_t = pa.struct([("id", pa.string()),
                      ("partitionColumns", pa.list_(pa.string())),
                      ("schemaString", pa.string()),
                      ("configuration", smap)])
    ckpt = pa.table({
        "add": pa.array([{"path": "day=2026-07-01/part.parquet",
                          "partitionValues": [("day", "2026-07-01")]},
                         None], type=add_t),
        "metaData": pa.array([None,
                              {"id": "t", "partitionColumns": ["day"],
                               "schemaString": schema_str,
                               "configuration": [("k", "v")]}], type=md_t),
    })
    pq.write_table(ckpt, os.path.join(log, f"{0:020d}.checkpoint.parquet"))
    with open(os.path.join(log, "_last_checkpoint"), "w") as f:
        json.dump({"version": 0, "size": 2}, f)
    ds = rd.read_delta(root)
    return ds.take_all(), ds.take_batch(7)


@program()
def read_iceberg_snapshot_and_time_travel(rt, rd, tmp):
    from tests.test_data import _write_iceberg_table

    root = str(tmp / "ice")
    _write_iceberg_table(root)
    return (_rows_by(rd.read_iceberg(root), "x"),
            _rows_by(rd.read_iceberg(root, snapshot_id=1), "x"),
            _rows_by(rd.read_iceberg(root, columns=["x"]), "x"),
            _raises(lambda: rd.read_iceberg(root, snapshot_id=99)),
            rd.read_iceberg(root, parallelism=1).take_batch(3))


@program()
def read_iceberg_without_version_hint(rt, rd, tmp):
    from tests.test_data import _write_iceberg_table

    root = str(tmp / "ice2")
    _write_iceberg_table(root)
    os.remove(os.path.join(root, "metadata", "version-hint.text"))
    return _rows_by(rd.read_iceberg(root), "x")


@program()
def read_iceberg_refuses_delete_manifests(rt, rd, tmp):
    from tests.test_data import (_ICEBERG_LIST_SCHEMA, _avro_write_ocf,
                                 _write_iceberg_table)

    root = str(tmp / "ice3")
    _write_iceberg_table(root)
    md = os.path.join(root, "metadata")
    ldel = os.path.join(md, "snap-3.avro")
    _avro_write_ocf(ldel, _ICEBERG_LIST_SCHEMA, [
        {"manifest_path": os.path.join(md, "m2.avro"),
         "manifest_length": 1, "partition_spec_id": 0, "content": 1}])
    meta = {"format-version": 2, "table-uuid": "t", "location": root,
            "current-snapshot-id": 3,
            "snapshots": [{"snapshot-id": 3, "manifest-list": ldel}]}
    with open(os.path.join(md, "v3.metadata.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(md, "version-hint.text"), "w") as f:
        f.write("3")
    try:
        rd.read_iceberg(root).take_all()
    except ValueError as e:
        return "ValueError", "delete" in str(e)
    return "returned"


@program()
def write_tfrecords_roundtrip_with_valid_crc(rt, rd, tmp):
    crc = _mod(rd, "datasource")._crc32c
    recs = [f"rec{i}".encode() for i in range(25)]
    n = rd.from_items([{"bytes": r} for r in recs]).write_tfrecords(
        str(tmp / "tfr"))
    files = sorted(os.listdir(tmp / "tfr"))
    raw = b"".join((tmp / "tfr" / f).read_bytes() for f in files)
    back = rd.read_tfrecords(str(tmp / "tfr"))
    return (crc(b"123456789") == 0xE3069283, n, files, raw,
            sorted(r["bytes"] for r in back.take_all()))


@program()
def read_tfrecords_token_rows(rt, rd, tmp):
    """Token rows written as int64 byte records, read back and decoded
    with map_batches, in the order the file holds them (one file, one
    block), as chip_smoke.py's phase 18 feeds its trials."""
    toks = np.random.default_rng(0).integers(0, 50257, (12, 33))
    # written by the module's writer: the reference's from_items drops
    # the records' trailing NUL bytes
    os.makedirs(tmp / "tok")
    _mod(rd, "datasource").write_tfrecords_file(
        [r.tobytes() for r in toks], str(tmp / "tok" / "part.tfrecords"))
    ds = rd.read_tfrecords(str(tmp / "tok")).map_batches(
        lambda b: {"tokens": np.stack(
            [np.frombuffer(x, dtype=np.int64) for x in b["bytes"]])})
    got = np.concatenate([b["tokens"] for b in ds.iter_batches(
        batch_size=4, prefetch_batches=0)])
    return got, bool((got == toks).all())


@program()
def dataset_stats_identifies_bottleneck(rt, rd, tmp):
    def fast(b):
        return {"id": [x * 2 for x in b["id"]]}

    def slow(b):
        time.sleep(0.1)
        return {"id": b["id"]}

    ds = (rd.range(200, parallelism=4).map_batches(fast)
          .random_shuffle(seed=7).map_batches(slow))
    n = ds.count()
    report = ds.stats()
    lines = report.splitlines()
    bn = [ln for ln in lines if "bottleneck:" in ln][0]
    names = [ln.strip().rstrip(":") for ln in lines
             if ln.strip().endswith(":")]
    return (n, names, bn.split("bottleneck:")[1].strip() == names[-1],
            "200 in -> 200 out" in report,
            any("wall" in ln and "cpu" in ln for ln in lines))


@program(rtol=1e-12)
def preprocessors_scalers_and_encoders(rt, rd, tmp):
    pp = _mod(rd, "preprocessors")
    n = 300
    rng = np.random.default_rng(0)
    xs = rng.normal(5.0, 2.0, n)
    ys = rng.uniform(10, 20, n)
    colors = rng.choice(["red", "green", "blue"], n)
    ds = rd.from_items([{"x": float(xs[i]), "y": float(ys[i]),
                         "color": str(colors[i])} for i in range(n)])
    ss = pp.StandardScaler(["x"]).fit(ds)
    scaled = np.concatenate([b["x"] for b in ss.transform(ds).iter_batches(
        batch_format="numpy")])
    mm = pp.MinMaxScaler(["y"]).fit(ds)
    oh = pp.OneHotEncoder(["color"]).fit(ds)
    first = next(iter(oh.transform(ds).iter_batches(batch_format="numpy")))
    le = pp.LabelEncoder("color").fit(ds)
    enc = le.transform_batch({"color": np.asarray(["blue", "red"])})
    imp = pp.SimpleImputer(["v"], strategy="mean").fit(rd.from_items(
        [{"v": 1.0}, {"v": float("nan")}, {"v": 3.0}]))
    imp2 = pp.SimpleImputer(["c"], strategy="most_frequent").fit(
        rd.from_items([{"c": "a"}, {"c": "a"}, {"c": "b"}]))
    oe = pp.OrdinalEncoder(["color"]).fit(ds)
    chain = pp.Chain(pp.StandardScaler(["x"]), pp.MinMaxScaler(["x"]),
                     pp.Concatenator(["x", "y"], output_column_name="vec"))
    chain.fit(ds)
    served = chain.transform_batch(
        {"x": np.asarray([5.0]), "y": np.asarray([15.0]),
         "color": np.asarray(["red"])})
    return (scaled, ss.stats_, mm.stats_,
            first, enc, le.inverse_transform_labels(enc["color"]),
            imp.transform_batch({"v": np.asarray([float("nan")])}),
            imp2.transform_batch({"c": np.asarray(["b", None, float("nan")],
                                                  dtype=object)}),
            oe.transform_batch({"color": np.asarray(["blue", "violet",
                                                     "red"])}),
            served,
            _raises(lambda: pp.StandardScaler(["x"]).transform(ds)))


@program(rtol=1e-12)
def preprocessors_text_and_hashing(rt, rd, tmp):
    pp = _mod(rd, "preprocessors")
    ds = rd.from_items([{"t": "the quick brown fox"}, {"t": "the lazy dog"}])
    hashed = pp.FeatureHasher(["t"], num_features=16)
    b = next(iter(hashed.transform(pp.Tokenizer(["t"]).transform(ds))
                  .iter_batches(batch_format="numpy")))
    vals = [float(v) for v in range(100)] + [1e9]
    rs = pp.RobustScaler(["v"]).fit(rd.from_items([{"v": v} for v in vals]))
    nz = pp.Normalizer(["a", "b"], norm="l2")
    return b, rs.stats_, nz.transform_batch({"a": np.asarray([3.0]),
                                             "b": np.asarray([4.0])})


@program()
def expressions_filter_and_with_column(rt, rd, tmp):
    col, lit = rd.col, rd.lit
    ds = rd.from_items([{"a": i, "b": i % 3} for i in range(30)])
    out = ds.filter(expr=(col("a") >= 10) & ~(col("b") == 0)) \
        .with_column("c", col("a") * 2 + lit(1)).take_all()
    ds2 = rd.from_items([{"x": 1.0}, {"x": float("nan")}, {"x": 3.0}])
    return (out, ds2.filter(col("x").is_null()).take_all(),
            ds.filter(expr=col("b").isin([1])).count(),
            _raises(lambda: bool(col("a") > 1)))


def _find_read(L, n):
    while not isinstance(n, L.Read):
        n = n.inputs[0]
    return n


@program()
def projection_pushdown_prunes_parquet_read(rt, rd, tmp):
    col = rd.col
    L = _mod(rd, "logical")
    opt = _mod(rd, "optimizer").LogicalOptimizer()
    rd.from_items([{"a": i, "b": 2 * i, "huge": "x" * 100, "c": i % 5}
                   for i in range(100)]).write_parquet(str(tmp))
    ds = (rd.read_parquet(str(tmp)).filter(expr=col("c") == 0)
          .with_column("d", col("b") + 1).select_columns(["a", "d"]))
    read = _find_read(L, opt.optimize(ds._logical_op))
    ds2 = rd.read_parquet(str(tmp), columns=["a"]).select_columns(["a"])
    read2 = _find_read(L, opt.optimize(ds2._logical_op))
    return (sorted(read.datasource._columns),
            read.datasource._filter is not None,
            sorted(ds.take_all(), key=lambda r: r["a"]),
            read2.datasource._columns)


@program()
def projection_pushdown_diamond_and_empty_needed(rt, rd, tmp):
    col, lit = rd.col, rd.lit
    rd.from_items([{"a": i, "b": 2 * i, "c": i % 2}
                   for i in range(10)]).write_parquet(str(tmp))
    base = rd.read_parquet(str(tmp)).filter(expr=col("c") == 0)
    rows = base.select_columns(["a"]).union(base).take_all()
    out = (rd.read_parquet(str(tmp)).with_column("d", lit(7))
           .select_columns(["d"]).take_all())
    return sorted(rows, key=lambda r: (len(r), r["a"])), out


@program()
def predicate_pushdown_into_parquet_scan(rt, rd, tmp):
    import pyarrow as pa
    import pyarrow.parquet as pq

    col = rd.col
    L = _mod(rd, "logical")
    opt = _mod(rd, "optimizer").LogicalOptimizer()
    pq.write_table(pa.table({"id": list(range(100)),
                             "val": [i * 2 for i in range(100)]}),
                   str(tmp / "t.parquet"), row_group_size=50)
    out = []
    for ds in (rd.read_parquet(str(tmp)).filter(expr=col("id") < 10),
               rd.read_parquet(str(tmp)).filter(expr=col("id") < 10)
               .filter(expr=col("val") > 4),
               rd.read_parquet(str(tmp)).filter(expr=col("id") / 4 == 1.0),
               rd.read_parquet(str(tmp)).filter(
                   expr=col("id").isin([3, 7]))):
        out.append((type(opt.optimize(ds._logical_op)).__name__,
                    sorted(r["id"] for r in ds.take_all())))
    return out


@program()
def predicate_pushdown_null_and_boolean_fidelity(rt, rd, tmp):
    import pyarrow as pa
    import pyarrow.parquet as pq

    col = rd.col
    opt = _mod(rd, "optimizer").LogicalOptimizer()
    pq.write_table(pa.table({"a": [1.0, None, 5.0],
                             "f1": [1, 0, 1], "f2": [1, 1, 0]}),
                   str(tmp / "t.parquet"))
    out = []
    for e in (col("a") != 5, ~(col("a") == 5), col("f1") & col("f2"),
              (col("a") >= 1) & (col("f1") == 1)):
        ds = rd.read_parquet(str(tmp)).filter(expr=e)
        out.append((type(opt.optimize(ds._logical_op)).__name__,
                    ds.take_all()))
    return out


@program()
def row_group_statistics_pruning(rt, rd, tmp):
    import pyarrow as pa
    import pyarrow.parquet as pq

    col = rd.col
    opt = _mod(rd, "optimizer").LogicalOptimizer()
    pq.write_table(pa.table({"id": list(range(400)),
                             "val": [i * 2 for i in range(400)]}),
                   str(tmp / "t.parquet"), row_group_size=100)
    may = _mod(rd, "expr").row_group_may_match
    st = {"id": (100, 199)}
    unit = [may(e, st) for e in (
        col("id") < 50, col("id") < 150, col("id") >= 200, col("id") == 42,
        col("id").isin([5, 900]), col("id").isin([5, 150]),
        (col("id") < 50) & (col("val") > 0),
        (col("id") < 50) | (col("id") > 150), col("other") < 0)]
    ds = rd.read_parquet(str(tmp)).filter(expr=col("id") < 100)
    src = opt.optimize(ds._logical_op).datasource
    blocks = list(src.read_file(str(tmp / "t.parquet")))
    return (unit, src.last_scan_row_groups,
            sum(b.num_rows for b in blocks),
            sorted(r["id"] for r in ds.take_all()), "100" in ds.stats())


@program()
def csv_json_predicate_pushdown_early_skip(rt, rd, tmp):
    import pyarrow as pa
    import pyarrow.csv as pacsv

    col = rd.col
    opt = _mod(rd, "optimizer").LogicalOptimizer()
    pacsv.write_csv(pa.table({"id": list(range(200)),
                              "v": [i % 7 for i in range(200)]}),
                    str(tmp / "a.csv"))
    with open(tmp / "b.jsonl", "w") as f:
        for i in range(200):
            f.write(json.dumps({"id": i, "v": i % 7}) + "\n")
    ds = rd.read_csv(str(tmp / "a.csv")).filter(expr=col("id") < 25)
    dj = rd.read_json(str(tmp / "b.jsonl")).filter(
        expr=(col("v") == 3) & (col("id") < 50))
    return (type(opt.optimize(ds._logical_op)).__name__,
            sorted(r["id"] for r in ds.take_all()), "25" in ds.stats(),
            type(opt.optimize(dj._logical_op)).__name__,
            sorted(r["id"] for r in dj.take_all()))


@program()
def data_map_streams_blocks_downstream(rt, rd, tmp):
    import re

    def double(batch):
        time.sleep(0.02)
        batch["id"] = batch["id"] * 2
        return batch

    def shift(batch):
        time.sleep(0.02)
        batch["id"] = batch["id"] + 1
        return batch

    ds = (rd.range(800, parallelism=4)
          .map_batches(double, batch_size=100, concurrency=2)
          .map_batches(shift, batch_size=100, concurrency=2))
    total = sum(int(b["id"].sum()) for b in ds.iter_batches(batch_size=100))
    maps = re.findall(r"MapBatches:.*?timeline: start \+([0-9.]+)s.*?done "
                      r"\+([0-9.]+)s", ds.stats(), re.S)
    return total, len(maps)


@program()
def executor_backpressure_bounds_queues(rt, rd, tmp):
    ctx = rd.DataContext.get_current()
    old = ctx.max_op_output_queue_blocks
    ctx.max_op_output_queue_blocks = 2
    try:
        ds = rd.range(400, parallelism=20).map_batches(
            lambda b: {"id": b["id"] + 1}, concurrency=2)
        got = [int(b["id"].sum()) for b in ds.iter_batches(
            batch_size=20, prefetch_batches=0)]
        return got, ds._context.max_op_output_queue_blocks
    finally:
        ctx.max_op_output_queue_blocks = old


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_matches_reference(pkgs, tmp_path, name):
    fn = PROGRAMS[name]
    got = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        rt, rd = pkgs[side]
        got[side] = _norm(fn(rt, rd, d))
    assert _close(got["port"], got["ref"], fn.rtol), \
        f"{name}:\nport {got['port']}\nref  {got['ref']}"


# ------------------------------------------------------------- port only


ROWS = [{"i": 1, "f": 0.25, "s": "x", "by": b"ab", "b": True,
         "n": None, "t": np.arange(6, dtype=np.int16).reshape(2, 3)},
        {"i": 2, "f": float("nan"), "s": "yy", "by": b"", "b": False,
         "n": None, "t": np.ones((2, 3), np.int16)}]


def test_block_python_types_match_arrow_to_pylist():
    """A block's rows give the Python types Arrow's ``to_pylist`` gives
    (int, float, str, bytes, bool, None), and an array for a tensor
    cell, as the reference's ``iter_rows`` does."""
    from ray_tpu.data.block import BlockAccessor as RefAccessor
    from ray_tpu_torch.data.block import BlockAccessor

    port = list(BlockAccessor(BlockAccessor.rows_to_block(ROWS)).iter_rows())
    ref_block = RefAccessor.rows_to_block(ROWS)
    ref = list(RefAccessor(ref_block).iter_rows())
    pylist = ref_block.drop(["t"]).to_pylist()
    for p, r, py in zip(port, ref, pylist):
        assert list(p) == list(r)
        for k in py:
            assert type(p[k]) is type(py[k]), (k, p[k], py[k])
            assert _norm(p[k]) == _norm(py[k])
        assert isinstance(p["t"], np.ndarray) and p["t"].dtype == np.int16
        np.testing.assert_array_equal(p["t"], r["t"])
    assert _norm(BlockAccessor(BlockAccessor.rows_to_block(ROWS))
                 .to_numpy()) == _norm(RefAccessor(ref_block).to_numpy())


def test_block_arrow_and_pandas_interop():
    from ray_tpu.data.block import BlockAccessor as RefAccessor
    from ray_tpu_torch.data import block as pb

    table = pb.BlockAccessor.rows_to_block(ROWS)
    ref_block = RefAccessor.rows_to_block(ROWS)
    arrow = pb.to_arrow(table)
    assert arrow.schema.metadata == ref_block.schema.metadata
    assert arrow.drop(["n"]).schema == ref_block.drop(["n"]).schema
    assert _norm(arrow.to_pylist()) == _norm(ref_block.to_pylist())
    back = pb.from_arrow(ref_block)
    assert _norm(list(pb.BlockAccessor(back).iter_rows())) == \
        _norm(list(RefAccessor(ref_block).iter_rows()))
    df = table.to_pandas()
    assert list(df.columns) == list(ref_block.to_pandas().columns)
    assert _norm(pb.BlockAccessor(pb.from_pandas(df.drop(columns=["t"])))
                 .to_numpy()["i"]) == _norm(np.asarray([1, 2]))


def _in_store(arr: np.ndarray) -> bool:
    from ray_tpu_torch.core import runtime_context

    mv = runtime_context.get_core().store._mv
    base = ctypes.addressof(ctypes.c_uint8.from_buffer(mv))
    ptr = arr.__array_interface__["data"][0]
    return base <= ptr and ptr + arr.nbytes <= base + mv.nbytes


def test_big_block_get_is_a_view_into_the_store(pkgs):
    """A block pickles as its numpy columns, which go out of band: the
    ``get`` of a 64 MiB block is a view into the shm store, no copy."""
    from ray_tpu_torch.data.block import BlockAccessor

    data = np.random.default_rng(0).standard_normal((64, 1 << 17)) \
        .astype(np.float64)
    block = BlockAccessor.batch_to_block({"x": data})
    assert block.nbytes == 64 << 20
    ref = ray_tpu_torch.put([block])
    got = ray_tpu_torch.get(ref)[0]
    col = got.column("x")
    assert _in_store(col)
    np.testing.assert_array_equal(col, data)
    ds = port_data.from_blocks([block])
    batch = next(iter(ds.iter_batches(batch_size=None, prefetch_batches=0)))
    assert _in_store(batch["x"]) and not batch["x"].flags.writeable


def test_import_loads_neither_torch_nor_arrow():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, ray_tpu_torch.data; print(*[m in sys.modules for m "
         "in ('torch', 'pyarrow', 'pandas')])"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=120)
    assert out.stdout.split() == ["False", "False", "False"]


def test_bytes_rows_keep_trailing_nuls(pkgs, tmp_path):
    """Byte and string rows end as they began, trailing NULs included:
    int64 token rows go through ``from_items``, ``write_tfrecords`` and
    ``read_tfrecords`` bit for bit (a numpy S array would strip the
    high zero bytes of small tokens; the reference's rows do)."""
    toks = np.random.default_rng(1).integers(0, 50257, (6, 9))
    recs = [r.tobytes() for r in toks]
    ds = port_data.from_items([{"bytes": r, "s": "a\0"} for r in recs],
                              parallelism=1)
    assert [r["bytes"] for r in ds.take_all()] == recs
    assert ds.take(1)[0]["s"] == "a\0"
    assert ds.write_tfrecords(str(tmp_path / "t")) == 6
    back = port_data.read_tfrecords(str(tmp_path / "t")).take_all()
    assert [r["bytes"] for r in back] == recs


def test_dataset_runs_inside_an_actor(pkgs):
    """A Dataset executed inside an actor, as a Tune trial reads its
    batches: the actor's streaming executor polls its read tasks'
    streams from a worker (``next_ref(timeout=0)``), which must ask the
    owner at least once (it used to give up before asking, and hang)."""

    @ray_tpu_torch.remote
    class Reader:
        def run(self, n):
            import ray_tpu_torch.data as rd

            ds = rd.range(n, parallelism=4).map_batches(
                lambda b: {"id": b["id"] * 2})
            return [int(b["id"].sum()) for b in ds.iter_batches(
                batch_size=16, prefetch_batches=0)]

    a = Reader.remote()
    try:
        got = ray_tpu_torch.get(a.run.remote(64), timeout=60)
    finally:
        ray_tpu_torch.kill(a)
    assert got == [2 * sum(range(i, i + 16)) for i in range(0, 64, 16)]


def test_data_all_is_the_reference_all():
    assert set(port_data.__all__) - {"Schema", "Table"} == \
        set(ref_data.__all__)


# A stand-in ``google.cloud.bigquery`` over one in-memory table: a table
# read lists row ranges, a query returns every row, a load job records
# its parquet payload in $FAKE_BQ_OUT. Nothing in it reaches a network.
_FAKE_BIGQUERY = """
import json
import os
import uuid

import pyarrow as pa

FAKE = True
_TABLE = pa.table({"k": list(range(10)), "s": [f"r{i}" for i in range(10)],
                   "f": [i / 4 for i in range(10)]})


class _Rows:
    def __init__(self, table):
        self._table = table

    def to_arrow(self):
        return self._table


class _Job:
    def result(self):
        return None


class _TableRef:
    num_rows = _TABLE.num_rows


class Client:
    def __init__(self, project=None):
        self.project = project

    def get_table(self, name):
        return _TableRef()

    def list_rows(self, name, start_index=0, max_results=None):
        return _Rows(_TABLE.slice(start_index, max_results))

    def query(self, sql):
        return _Rows(_TABLE)

    def load_table_from_file(self, buf, name, job_config=None):
        import pyarrow.parquet as pq

        rows = pq.read_table(buf).to_pylist()
        out = os.path.join(os.environ["FAKE_BQ_OUT"], uuid.uuid4().hex)
        with open(out, "w") as f:
            json.dump([name, job_config.source_format, rows], f)
        return _Job()


class LoadJobConfig:
    def __init__(self, source_format=None):
        self.source_format = source_format


class SourceFormat:
    PARQUET = "PARQUET"
"""

# both packages' BigQuery paths in one process whose workers import the
# fake client too (it comes first on their PYTHONPATH)
_BIGQUERY_DRIVE = """
import json
import os
import pickle
import sys

import google.cloud.bigquery as bq
import ray_tpu
import ray_tpu.data as ref_data
import ray_tpu_torch
import ray_tpu_torch.data as port_data

assert bq.FAKE
out_dir = os.environ["FAKE_BQ_OUT"]


def refusal(rd):
    try:
        rd.read_bigquery("proj")
    except Exception as e:  # noqa: BLE001 - compared by type name
        return type(e).__name__
    return "returned"


got = {}
ray_tpu.init(num_workers=2, object_store_memory=64 << 20)
ray_tpu_torch.init(num_workers=2, object_store_memory=64 << 20)
try:
    for side, rd in (("ref", ref_data), ("port", port_data)):
        ds = rd.read_bigquery("proj", dataset="d.t", parallelism=3)
        q = rd.read_bigquery("proj", query="SELECT *")
        n = rd.from_items([{"a": i, "b": f"w{i}"} for i in range(5)],
                          parallelism=2).write_bigquery("proj", "d.out")
        loads = []
        for name in sorted(os.listdir(out_dir)):
            with open(os.path.join(out_dir, name)) as f:
                loads.append(json.load(f))
            os.remove(os.path.join(out_dir, name))
        got[side] = (sorted(ds.take_all(), key=lambda r: r["k"]),
                     q.take_batch(4), n, sorted(map(repr, loads)),
                     refusal(rd))
finally:
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()
with open(sys.argv[1], "wb") as f:
    pickle.dump(got, f)
"""


def test_bigquery_read_and_write_through_a_fake_client(tmp_path):
    """read_bigquery (a table in three row ranges, and a query) and
    write_bigquery through both packages against a fake
    ``google.cloud.bigquery`` module, in a process (and workers) where
    the fake is the module that imports: the same rows, batches, row
    counts and loaded payloads, and the same refusal of a read that
    names neither a table nor a query."""
    import pickle

    fake = tmp_path / "fake" / "google" / "cloud" / "bigquery"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text(_FAKE_BIGQUERY)
    loads = tmp_path / "loads"
    loads.mkdir()
    env = dict(os.environ, FAKE_BQ_OUT=str(loads),
               PYTHONPATH=os.pathsep.join([str(tmp_path / "fake"),
                                           str(ROOT)]))
    out = tmp_path / "got.pkl"
    proc = subprocess.run([sys.executable, "-c", _BIGQUERY_DRIVE, str(out)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        got = pickle.load(f)
    assert got["port"][2] == 5 and len(got["port"][3]) == 2
    assert _norm(got["port"]) == _norm(got["ref"]), got


def test_num_gpus_maps_to_a_gpu_actor_pool():
    """``map_batches(num_gpus=)`` asks the actor pool for GPUs, where the
    reference's ``num_chips=`` asks for TPUs."""
    from ray_tpu_torch.data.physical import ActorPoolMapOperator
    from ray_tpu_torch.data.planner import Planner

    ds = port_data.range(8).map_batches(lambda b: b, num_gpus=1,
                                        concurrency=1)
    topo = Planner(ds._context).plan(ds._logical_op)
    ops = [op for op in topo.ops if isinstance(op, ActorPoolMapOperator)]
    assert len(ops) == 1 and ops[0]._resources == {"num_gpus": 1}
