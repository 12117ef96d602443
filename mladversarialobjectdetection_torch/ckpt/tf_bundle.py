"""TensorFlow tensor bundles (TF1 name-based checkpoints) read without TensorFlow.

The reference's release checkpoints are tensor bundles, the format of
`tf.train.Saver` / `tf.raw_ops.SaveV2`; the JAX package reads them with
`tf.train.load_checkpoint` (convert_tf.py:108-123), which the card's machine
cannot run. This module reads them by hand, as `data/tfrecord.py` reads
TFRecords:

- `<prefix>.index` is a LevelDB-style table: a 48-byte footer (the
  metaindex and index `BlockHandle`s as varints, padded to 40 bytes, then the
  magic 0xdb4775248b80fb57 as a little-endian fixed64); blocks of entries
  with prefix-compressed keys (shared, unshared and value lengths as
  varints) and a restart array, each block followed by a 5-byte trailer (a
  compression type, which must be 0, and the masked CRC32C of the block and
  that byte). The index block maps separator keys to the data blocks.
- The entry keyed "" is a `BundleHeaderProto` (`num_shards`,
  `endianness`); every other entry is a tensor's `BundleEntryProto`
  (`dtype`, `shape`, `shard_id`, `offset`, `size`, the masked `crc32c` of
  its bytes; an entry with `slices` is a partitioned variable and raises).
  The protobufs are decoded as varint and length-delimited fields.
- A tensor's bytes lie at `offset` in `<prefix>.data-{shard:05d}-of-
  {num_shards:05d}`, little-endian, C order.

Each tensor's CRC is checked with `data/tfrecord.masked_crc32c` (the native
CRC where `cc` can build it: a lite4 bundle holds about 60 MB).
"""
from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..data import tfrecord

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
TRAILER_BYTES = 5

# tensorflow/core/framework/types.proto DataType -> numpy
DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
          6: np.int8, 9: np.int64, 10: np.bool_, 17: np.uint16, 19: np.float16,
          22: np.uint32, 23: np.uint64}
DTYPE_NAMES = {7: "DT_STRING", 8: "DT_COMPLEX64", 11: "DT_QINT8",
               12: "DT_QUINT8", 13: "DT_QINT32", 14: "DT_BFLOAT16",
               15: "DT_QINT16", 16: "DT_QUINT16", 18: "DT_COMPLEX128",
               20: "DT_RESOURCE", 21: "DT_VARIANT"}


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, object]]:
    """(field number, value) of a protobuf message: varints as ints, fixed32 /
    fixed64 as ints, length-delimited fields as bytes."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 1:
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            val = buf[pos:pos + n]
            pos += n
        elif wire == 5:
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"protobuf wire type {wire} is not supported")
        yield num, val


def _block_handle(buf: bytes, pos: int = 0) -> Tuple[Tuple[int, int], int]:
    offset, pos = _varint(buf, pos)
    size, pos = _varint(buf, pos)
    return (offset, size), pos


def _read_block(data: bytes, handle: Tuple[int, int], path: str) -> bytes:
    offset, size = handle
    end = offset + size + TRAILER_BYTES
    if end > len(data):
        raise ValueError(f"{path}: block at {offset} runs past the file")
    block = data[offset:offset + size]
    kind = data[offset + size]
    if kind != 0:
        raise ValueError(f"{path}: block at {offset} has compression type "
                         f"{kind}; only uncompressed tables are read")
    crc = struct.unpack_from("<I", data, offset + size + 1)[0]
    if tfrecord.masked_crc32c(data[offset:offset + size + 1]) != crc:
        raise ValueError(f"{path}: CRC mismatch in the block at {offset}")
    return block


def _block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """(key, value) of every entry of a table block, keys undone from their
    shared prefixes."""
    if len(block) < 4:
        raise ValueError("table block too short")
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    limit = len(block) - 4 - 4 * n_restarts
    pos, key = 0, b""
    while pos < limit:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        n_value, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        yield key, block[pos:pos + n_value]
        pos += n_value


def read_index(prefix: str) -> Dict[str, bytes]:
    """{key: value} of `<prefix>.index` (the header's key is "")."""
    path = prefix + ".index"
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < FOOTER_BYTES:
        raise ValueError(f"{path}: too short for a table footer")
    footer = data[-FOOTER_BYTES:]
    if struct.unpack_from("<Q", footer, 40)[0] != TABLE_MAGIC:
        raise ValueError(f"{path}: not a TF tensor bundle index (bad magic)")
    _, pos = _block_handle(footer)          # the metaindex, empty in bundles
    index_handle, _ = _block_handle(footer, pos)
    out = {}
    for _, handle_bytes in _block_entries(_read_block(data, index_handle, path)):
        handle, _ = _block_handle(handle_bytes)
        for key, value in _block_entries(_read_block(data, handle, path)):
            out[key.decode("utf-8")] = value
    return out


def _shape(buf: bytes) -> List[int]:
    dims = []
    for num, val in _fields(buf):
        if num == 2:
            size = 0
            for dnum, dval in _fields(val):
                if dnum == 1:
                    size = dval
            dims.append(size)
        elif num == 3 and val:
            raise ValueError("a tensor of unknown rank")
    return dims


def parse_entry(buf: bytes) -> dict:
    """A `BundleEntryProto`: dtype, shape, shard_id, offset, size, crc32c."""
    entry = {"dtype": 0, "shape": [], "shard_id": 0, "offset": 0, "size": 0,
             "crc32c": None}
    names = {1: "dtype", 3: "shard_id", 4: "offset", 5: "size", 6: "crc32c"}
    for num, val in _fields(buf):
        if num == 2:
            entry["shape"] = _shape(val)
        elif num == 7:
            raise ValueError("a sliced (partitioned) tensor is not read")
        elif num in names:
            entry[names[num]] = val
    return entry


def _ensure_native_crc() -> None:
    """Build the native CRC (`csrc/tfrecord_native.c`) where a C compiler is
    at hand; the pure-Python CRC stays the fallback."""
    from .. import _build
    if _build.load_tfrecord_native() is None:
        try:
            _build.build_tfrecord_native()
        except (OSError, RuntimeError):
            pass


def read_bundle(prefix: str, *, verify_crc: bool = True) -> Dict[str, np.ndarray]:
    """{tensor name: array} of the tensor bundle at `prefix` (no TensorFlow)."""
    if verify_crc:
        _ensure_native_crc()
    index = read_index(prefix)
    if "" not in index:
        raise ValueError(f"{prefix}.index: no bundle header")
    num_shards, endianness = 1, 0
    for num, val in _fields(index.pop("")):
        if num == 1:
            num_shards = val
        elif num == 2:
            endianness = val
    if endianness != 0:
        raise ValueError(f"{prefix}: a big-endian bundle is not read")
    shards: Dict[int, bytes] = {}
    out = {}
    for name, raw in sorted(index.items()):
        entry = parse_entry(raw)
        dtype = DTYPES.get(entry["dtype"])
        if dtype is None:
            kind = DTYPE_NAMES.get(entry["dtype"], f"DataType {entry['dtype']}")
            raise ValueError(f"{prefix}: tensor {name!r} has dtype {kind}, "
                             "which is not read")
        sid = entry["shard_id"]
        if sid not in shards:
            shard = f"{prefix}.data-{sid:05d}-of-{num_shards:05d}"
            if not os.path.isfile(shard):
                raise FileNotFoundError(shard)
            with open(shard, "rb") as f:
                shards[sid] = f.read()
        start, size = entry["offset"], entry["size"]
        raw_bytes = shards[sid][start:start + size]
        if len(raw_bytes) != size:
            raise ValueError(f"{prefix}: tensor {name!r} runs past its shard")
        if verify_crc and entry["crc32c"] is not None and (
                tfrecord.masked_crc32c(raw_bytes) != entry["crc32c"]):
            raise ValueError(f"{prefix}: CRC mismatch in tensor {name!r}")
        arr = np.frombuffer(raw_bytes, dtype=np.dtype(dtype).newbyteorder("<"))
        arr = arr.astype(dtype).reshape(entry["shape"])
        out[name] = arr[()] if arr.ndim == 0 else arr  # a scalar, as TF's reader
    return out
