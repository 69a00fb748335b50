"""Datasources: pluggable readers/writers producing/consuming blocks.

Reference: ``python/ray/data/datasource/`` — ``Datasource.get_read_tasks`` returns
serializable ``ReadTask`` thunks that execute remotely and yield blocks;
``file_based_datasource.py`` is the shared framework for parquet/csv/json/numpy.
"""

from __future__ import annotations

import glob as globlib
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import pyarrow as pa

from .block import Block, BlockAccessor, BlockMetadata, VALUE_COL


@dataclass
class ReadTask:
    """A serializable zero-arg callable producing an iterable of blocks, plus
    metadata estimated at planning time (before any data is read)."""
    read_fn: Callable[[], Iterable[Block]]
    metadata: BlockMetadata

    def __call__(self) -> Iterable[Block]:
        return self.read_fn()


class Datasource:
    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__.replace("Datasource", "")


class RangeDatasource(Datasource):
    def __init__(self, n: int, *, tensor_shape: Optional[tuple] = None):
        self._n = n
        self._tensor_shape = tensor_shape

    def estimate_inmemory_data_size(self):
        per = 8 if not self._tensor_shape else 8 * int(np.prod(self._tensor_shape))
        return self._n * per

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        parallelism = max(1, min(parallelism, self._n)) if self._n else 1
        tasks = []
        chunk = -(-self._n // parallelism) if self._n else 0
        shape = self._tensor_shape
        for i in range(parallelism):
            lo, hi = i * chunk, min((i + 1) * chunk, self._n)
            if lo >= hi:
                break

            def make(lo=lo, hi=hi):
                if shape is None:
                    return [pa.table({"id": pa.array(range(lo, hi), type=pa.int64())})]
                data = np.stack([np.full(shape, v, dtype=np.int64) for v in range(lo, hi)])
                return [BlockAccessor.for_block(
                    [{"data": row} for row in data]).to_arrow()]

            nbytes = (hi - lo) * (8 if shape is None else 8 * int(np.prod(shape)))
            tasks.append(ReadTask(make, BlockMetadata(num_rows=hi - lo, size_bytes=nbytes)))
        return tasks


class ItemsDatasource(Datasource):
    def __init__(self, items: List[Any]):
        self._items = items

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        n = len(self._items)
        parallelism = max(1, min(parallelism, n)) if n else 1
        chunk = -(-n // parallelism) if n else 0
        tasks = []
        for i in range(parallelism):
            part = self._items[i * chunk:(i + 1) * chunk]
            if not part:
                break

            def make(part=part):
                if part and isinstance(part[0], dict):
                    return [BlockAccessor.for_block(part).to_arrow()]
                return [part]

            tasks.append(ReadTask(make, BlockMetadata(num_rows=len(part), size_bytes=None)))
        return tasks


class BlocksDatasource(Datasource):
    """Pre-materialized in-memory blocks (from_pandas / from_arrow / from_numpy)."""

    def __init__(self, blocks: List[Block]):
        self._blocks = blocks

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        tasks = []
        for b in self._blocks:
            acc = BlockAccessor.for_block(b)
            tasks.append(ReadTask(lambda b=b: [b], acc.metadata()))
        return tasks


def _expand_paths(paths, ext: Optional[str]) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            pat = os.path.join(p, "**", f"*{ext}" if ext else "*")
            out.extend(sorted(f for f in globlib.glob(pat, recursive=True)
                              if os.path.isfile(f)))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(globlib.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths}")
    return out


class FileBasedDatasource(Datasource):
    """Framework for path-list datasources — one or more files per read task.

    Reference: ``python/ray/data/datasource/file_based_datasource.py``.
    """

    _FILE_EXTENSION: Optional[str] = None

    def __init__(self, paths, **reader_args):
        self._paths = _expand_paths(paths, self._FILE_EXTENSION)
        self._reader_args = reader_args

    def _read_file(self, path: str) -> Iterable[Block]:
        raise NotImplementedError

    def estimate_inmemory_data_size(self):
        try:
            return sum(os.path.getsize(p) for p in self._paths)
        except OSError:
            return None

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        n = len(self._paths)
        parallelism = max(1, min(parallelism, n))
        per = -(-n // parallelism)
        tasks = []
        for i in range(parallelism):
            chunk = self._paths[i * per:(i + 1) * per]
            if not chunk:
                break
            read_file = self._read_file

            def make(chunk=chunk, read_file=read_file):
                def gen():
                    for p in chunk:
                        yield from read_file(p)
                return gen()

            size = None
            try:
                size = sum(os.path.getsize(p) for p in chunk)
            except OSError:
                pass
            tasks.append(ReadTask(make, BlockMetadata(num_rows=None, size_bytes=size,
                                                      input_files=chunk)))
        return tasks


class ParquetDatasource(FileBasedDatasource):
    _FILE_EXTENSION = ".parquet"

    def _read_file(self, path):
        import pyarrow.parquet as pq
        columns = self._reader_args.get("columns")
        yield pq.read_table(path, columns=columns)


class ORCDatasource(FileBasedDatasource):
    """Apache ORC columnar files via pyarrow.orc (reference:
    ``python/ray/data/read_api.py`` read_orc)."""

    _FILE_EXTENSION = ".orc"

    def _read_file(self, path):
        from pyarrow import orc as porc
        columns = self._reader_args.get("columns")
        yield porc.read_table(path, columns=columns)


class WebDatasetDatasource(FileBasedDatasource):
    """WebDataset-style tar shards: samples are groups of files sharing a
    basename (``0001.jpg`` + ``0001.cls`` -> one row with columns per
    extension) — the standard large-scale ML ingest container (reference:
    ``python/ray/data/read_api.py`` read_webdataset; stdlib tarfile, no
    webdataset dependency)."""

    _FILE_EXTENSION = ".tar"

    def _read_file(self, path):
        import tarfile

        samples: Dict[str, Dict[str, Any]] = {}
        order: List[str] = []
        with tarfile.open(path) as tf:
            for member in tf:
                if not member.isfile():
                    continue
                base, dot, ext = member.name.partition(".")
                if not dot:
                    base, ext = member.name, "data"
                if base not in samples:
                    samples[base] = {"__key__": base}
                    order.append(base)
                samples[base][ext] = tf.extractfile(member).read()
        rows = [samples[k] for k in order]
        if rows:
            yield BlockAccessor.for_block(rows).to_arrow()


class CSVDatasource(FileBasedDatasource):
    _FILE_EXTENSION = ".csv"

    def _read_file(self, path):
        from pyarrow import csv as pcsv
        yield pcsv.read_csv(path, **self._reader_args)


class JSONDatasource(FileBasedDatasource):
    _FILE_EXTENSION = ".json"

    def _read_file(self, path):
        from pyarrow import json as pjson
        yield pjson.read_json(path)


class NumpyDatasource(FileBasedDatasource):
    _FILE_EXTENSION = ".npy"

    def _read_file(self, path):
        arr = np.load(path, allow_pickle=False)
        yield BlockAccessor.for_block([{"data": row} for row in arr]).to_arrow()


class BinaryDatasource(FileBasedDatasource):
    _FILE_EXTENSION = None

    def _read_file(self, path):
        with open(path, "rb") as f:
            data = f.read()
        yield pa.table({"bytes": pa.array([data], type=pa.binary()),
                        "path": pa.array([path])})


class TextDatasource(FileBasedDatasource):
    _FILE_EXTENSION = None

    def _read_file(self, path):
        with open(path, "r", errors="replace") as f:
            lines = [ln.rstrip("\n") for ln in f]
        yield pa.table({"text": pa.array(lines)})


class TFRecordDatasource(FileBasedDatasource):
    """TFRecord files of serialized ``tf.train.Example`` protos (or raw
    records with ``raw=True``).

    Reference: ``python/ray/data/datasource`` TFRecords support.  The wire
    format is parsed directly — length-delimited records with masked CRCs —
    and Example features are decoded with a minimal protobuf wire-format
    reader, so neither tensorflow nor protoc-generated stubs are needed.
    """

    _FILE_EXTENSION = None

    def _read_file(self, path):
        raw = self._reader_args.get("raw", False)
        records = list(_iter_tfrecords(path))
        if raw:
            yield pa.table({"bytes": pa.array(records, type=pa.binary())})
            return
        rows = [_parse_tf_example(r) for r in records]
        yield BlockAccessor.for_block(rows).to_arrow()


def _iter_tfrecords(path: str):
    """TFRecord framing: u64 length, u32 length-crc, payload, u32 data-crc.
    CRCs are not verified (matches the reference's default fast path)."""
    with open(path, "rb") as f:
        while True:
            head = f.read(8)
            if len(head) < 8:
                return
            (length,) = __import__("struct").unpack("<Q", head)
            f.read(4)  # length crc
            payload = f.read(length)
            if len(payload) < length:
                raise ValueError(f"truncated tfrecord in {path}")
            f.read(4)  # data crc
            yield payload


def _read_varint(buf: bytes, pos: int):
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _parse_tf_example(data: bytes) -> Dict[str, Any]:
    """Decode tf.train.Example -> {feature: value(s)} with a minimal proto
    wire reader.  Example := {1: Features{1: map<string, Feature>}};
    Feature := one of {1: BytesList, 2: FloatList, 3: Int64List}."""
    import struct

    def fields(buf):
        pos = 0
        while pos < len(buf):
            key, pos = _read_varint(buf, pos)
            tag, wire = key >> 3, key & 7
            if wire == 2:  # length-delimited
                ln, pos = _read_varint(buf, pos)
                yield tag, buf[pos:pos + ln]
                pos += ln
            elif wire == 0:
                v, pos = _read_varint(buf, pos)
                yield tag, v
            elif wire == 5:
                yield tag, buf[pos:pos + 4]
                pos += 4
            elif wire == 1:
                yield tag, buf[pos:pos + 8]
                pos += 8
            else:
                raise ValueError(f"unsupported wire type {wire}")

    def parse_list(kind: int, buf: bytes):
        vals: List[Any] = []
        for tag, v in fields(buf):
            if tag != 1:
                continue
            if kind == 1:        # BytesList: repeated bytes
                vals.append(v)
            elif kind == 2:      # FloatList: packed or unpacked floats
                if isinstance(v, bytes) and len(v) == 4:
                    vals.append(struct.unpack("<f", v)[0])
                else:
                    vals.extend(struct.unpack(f"<{len(v) // 4}f", v))
            else:                # Int64List: packed or unpacked varints
                if isinstance(v, int):  # wire type 0: one unpacked element
                    vals.append(v - (1 << 64) if v >= 1 << 63 else v)
                    continue
                pos = 0
                while pos < len(v):
                    x, pos = _read_varint(v, pos)
                    vals.append(x - (1 << 64) if x >= 1 << 63 else x)
        return vals

    row: Dict[str, Any] = {}
    for tag, features in fields(data):
        if tag != 1:
            continue
        for ftag, entry in fields(features):
            if ftag != 1:
                continue
            name, feature = None, None
            for etag, v in fields(entry):
                if etag == 1:
                    name = v.decode()
                elif etag == 2:
                    feature = v
            if name is None or feature is None:
                continue
            for kind, payload in fields(feature):
                vals = parse_list(kind, payload)
                row[name] = vals[0] if len(vals) == 1 else vals
    return row


def _write_varint(out: bytearray, v: int):
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return


def _encode_tf_example(row: Dict[str, Any]) -> bytes:
    """Inverse of _parse_tf_example (used by Dataset.write_tfrecords)."""
    import struct

    def ld(tag: int, payload: bytes) -> bytes:
        head = bytearray()
        _write_varint(head, (tag << 3) | 2)
        _write_varint(head, len(payload))
        return bytes(head) + payload

    feats = bytearray()
    for name, value in row.items():
        vals = value if isinstance(value, (list, np.ndarray)) else [value]
        inner = bytearray()
        first = vals[0] if len(vals) else 0
        if isinstance(first, (bytes, str)):
            bl = bytearray()
            for v in vals:
                bl += ld(1, v.encode() if isinstance(v, str) else bytes(v))
            inner += ld(1, bytes(bl))
        elif isinstance(first, (float, np.floating)):
            packed = struct.pack(f"<{len(vals)}f", *[float(v) for v in vals])
            inner += ld(2, ld(1, packed))
        else:
            iv = bytearray()
            for v in vals:
                _write_varint(iv, int(v) & ((1 << 64) - 1))
            inner += ld(3, ld(1, bytes(iv)))
        feats += ld(1, ld(1, name.encode()) + ld(2, bytes(inner)))
    return ld(1, bytes(feats))


_CRC32C_TABLE = None
try:  # C implementations first: the pure-Python loop is ~10 MB/s
    import crc32c as _crc32c_ext  # type: ignore
except ImportError:
    try:
        import google_crc32c as _g_crc32c  # type: ignore

        class _crc32c_ext:  # adapt to the crc32c package's call shape
            crc32c = staticmethod(lambda b: _g_crc32c.value(b))
    except ImportError:
        _crc32c_ext = None

_native_crc_state = "unloaded"  # -> callable | "failed"


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, poly 0x1EDC6F41 reflected = 0x82F63B78).
    Prefers a pypi C extension, then our own native component
    (native/crc32c.cpp: SSE4.2 / slice-by-8, compiled lazily on the
    FIRST checksum so importing this module never spawns g++), then the
    pure-Python table loop."""
    global _native_crc_state
    if _crc32c_ext is not None:
        return _crc32c_ext.crc32c(data) & 0xFFFFFFFF
    if _native_crc_state == "unloaded":
        from ray_tpu_torch.native import load_crc32c
        _native_crc_state = load_crc32c() or "failed"
    if _native_crc_state != "failed":
        return _native_crc_state(data) & 0xFFFFFFFF
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    crc = 0xFFFFFFFF
    tab = _CRC32C_TABLE
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC (reference: tfrecords_datasource.py
    ``_masked_crc``): rotate right by 15 and add a constant."""
    crc = _crc32c(data)
    rotated = ((crc >> 15) | ((crc << 17) & 0xFFFFFFFF)) & 0xFFFFFFFF
    return (rotated + 0xA282EAD8) & 0xFFFFFFFF


def _tfrecord_frame(payload: bytes) -> bytes:
    """Frame one record with masked crc32c over the length and data fields —
    the exact wire format TF's reader verifies by default."""
    import struct
    length = struct.pack("<Q", len(payload))
    return (length + struct.pack("<I", _masked_crc32c(length))
            + payload + struct.pack("<I", _masked_crc32c(payload)))


class SQLDatasource(Datasource):
    """Rows from a SQL query via a DB-API connection factory.

    Reference: ``python/ray/data/datasource/sql_datasource.py`` — the same
    ``connection_factory + query`` contract (sqlite3 from the stdlib works
    out of the box).  Parallelism is 1 unless the caller provides
    ``shard_queries`` (DB-API has no generic cheap row-range split).
    """

    def __init__(self, sql: str, connection_factory: Callable[[], Any],
                 shard_queries: Optional[List[str]] = None):
        self._sql = sql
        self._factory = connection_factory
        self._shards = shard_queries

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        queries = self._shards or [self._sql]
        factory = self._factory

        def make(q):
            def read():
                conn = factory()
                try:
                    cur = conn.cursor()
                    cur.execute(q)
                    cols = [d[0] for d in cur.description]
                    rows = cur.fetchall()
                finally:
                    conn.close()
                if not rows:
                    return []
                table = pa.table({c: pa.array([r[i] for r in rows])
                                  for i, c in enumerate(cols)})
                return [table]
            return read

        return [ReadTask(make(q), BlockMetadata(num_rows=None,
                                                size_bytes=None))
                for q in queries]


class ImageDatasource(FileBasedDatasource):
    """Image files decoded to HWC uint8 arrays (requires PIL, present in
    most ML images; raises a clear error if absent).

    Reference: ``python/ray/data/datasource/image_datasource.py`` —
    same columns: ``image`` (ndarray) and ``path``.
    """

    _FILE_EXTENSION = None
    _EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")

    def __init__(self, paths, size: Optional[tuple] = None,
                 mode: Optional[str] = None, **kw):
        super().__init__(paths, **kw)
        self._paths = [p for p in self._paths
                       if p.lower().endswith(self._EXTS)]
        if not self._paths:
            raise FileNotFoundError(f"no image files under {paths}")
        self._size = size
        self._mode = mode

    def _read_file(self, path):
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                "read_images requires pillow (PIL); not in this image"
            ) from e
        img = Image.open(path)
        if self._mode:
            img = img.convert(self._mode)
        if self._size:
            # size is (height, width) like the reference's read_images;
            # PIL's resize takes (width, height), so swap.
            img = img.resize((self._size[1], self._size[0]))
        arr = np.asarray(img)
        yield BlockAccessor.for_block(
            [{"image": arr, "path": path}]).to_arrow()


# ---------------------------------------------------------------------------
# Write path
# ---------------------------------------------------------------------------

def write_block(block: Block, path: str, file_format: str, index: int,
                **writer_args) -> str:
    os.makedirs(path, exist_ok=True)
    acc = BlockAccessor.for_block(block)
    fname = os.path.join(path, f"part-{index:06d}.{file_format}")
    if file_format == "parquet":
        import pyarrow.parquet as pq
        pq.write_table(acc.to_arrow(), fname, **writer_args)
    elif file_format == "csv":
        from pyarrow import csv as pcsv
        pcsv.write_csv(acc.to_arrow(), fname)
    elif file_format == "json":
        df = acc.to_pandas()
        df.to_json(fname, orient="records", lines=True)
    elif file_format == "npy":
        cols = acc.to_numpy()
        key = "data" if "data" in cols else list(cols)[0]
        np.save(fname[:-4], cols[key])
    elif file_format == "orc":
        from pyarrow import orc as porc
        porc.write_table(acc.to_arrow(), fname, **writer_args)
    elif file_format == "tar":  # webdataset shard
        import io as _io
        import tarfile
        with tarfile.open(fname, "w") as tf:
            for i, row in enumerate(acc.iter_rows()):
                if not isinstance(row, dict):
                    row = {"data": row}
                key = row.get("__key__", f"{index:06d}{i:06d}")
                for ext, payload in row.items():
                    if ext == "__key__":
                        continue
                    if not isinstance(payload, bytes):
                        payload = str(payload).encode()
                    info = tarfile.TarInfo(f"{key}.{ext}")
                    info.size = len(payload)
                    tf.addfile(info, _io.BytesIO(payload))
    elif file_format == "tfrecords":
        with open(fname, "wb") as f:
            for row in acc.iter_rows():
                if not isinstance(row, dict):
                    row = {"value": row}
                f.write(_tfrecord_frame(_encode_tf_example(row)))
    else:
        raise ValueError(f"unknown write format {file_format}")
    return fname


class MongoDatasource(Datasource):
    """Documents from a MongoDB collection, partitioned by skip/limit.

    Reference: ``python/ray/data/_internal/datasource/mongo_datasource.py``
    (read_mongo/write_mongo over pymongo).  pymongo is not baked into this
    image, so the client comes from an injectable ``client_factory``
    (production: ``lambda: pymongo.MongoClient(uri)``; tests: a fake) and
    the default factory raises a clear ImportError only when actually used.
    An optional aggregation ``pipeline`` runs server-side before the
    partition window, matching the reference's pipeline argument.
    """

    def __init__(self, uri: str, database: str, collection: str,
                 pipeline: Optional[List[dict]] = None,
                 client_factory: Optional[Callable[[], Any]] = None):
        self._uri = uri
        self._db = database
        self._coll = collection
        self._pipeline = list(pipeline or [])
        self._factory = client_factory or _default_mongo_client(uri)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        factory, db, coll = self._factory, self._db, self._coll
        pipeline = self._pipeline

        def make(stages):
            def read():
                c = factory()
                try:
                    cur = c[db][coll].aggregate(stages)
                    docs = [{k: v for k, v in d.items() if k != "_id"}
                            for d in cur]
                finally:
                    _close_quietly(c)
                if not docs:
                    return []
                cols = sorted({k for d in docs for k in d})
                return [pa.table({k: pa.array([d.get(k) for d in docs])
                                  for k in cols})]
            return read

        meta = BlockMetadata(num_rows=None, size_bytes=None)
        if pipeline:
            # An aggregation pipeline can change cardinality ($unwind,
            # $group), so collection-count skip/limit windows would drop or
            # duplicate output rows — run it as ONE partition (the
            # reference partitions on _id ranges BEFORE the pipeline; that
            # needs server-side _id introspection pymongo-side).
            return [ReadTask(make(list(pipeline)), meta)]
        client = factory()
        try:
            total = client[db][coll].count_documents({})
        finally:
            _close_quietly(client)
        if total == 0:
            # empty collection: one windowless scan (MongoDB rejects
            # {"$limit": 0})
            return [ReadTask(make([]), meta)]
        parallelism = max(1, min(parallelism if parallelism > 0 else 8,
                                 total))
        per = -(-total // parallelism)  # ceil
        # $sort on _id pins a stable document order so the independent
        # per-partition cursors neither overlap nor leave gaps
        return [ReadTask(make([{"$sort": {"_id": 1}},
                               {"$skip": i * per}, {"$limit": per}]), meta)
                for i in range(parallelism)]


def _default_mongo_client(uri: str) -> Callable[[], Any]:
    def factory():
        try:
            import pymongo
        except ImportError as e:
            raise ImportError(
                "read_mongo requires pymongo (not in this image); pass "
                "client_factory=... to supply a client") from e
        return pymongo.MongoClient(uri)
    return factory


def _close_quietly(client: Any) -> None:
    try:
        client.close()
    except Exception:
        pass


