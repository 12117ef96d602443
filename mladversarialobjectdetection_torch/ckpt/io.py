"""Checkpoint files in the JAX package's formats.

Port of `mladversarialobjectdetection_tpu/ckpt/io.py`:

- `save_pytree` / `load_pytree`: `<path>.pkl`, a pickled nested dict of
  numpy arrays, the file JAX's `save_pytree` writes when orbax is absent
  (io.py:27-31) and its `load_pytree` reads (io.py:57-60). `load_pytree`
  also reads the orbax directory JAX writes where orbax is installed
  (io.py:52-56), with tensorstore and without orbax, which imports JAX
  (`_load_orbax`).
- `save_state_bytes` / `load_state_bytes` (io.py:34-48): flax's msgpack
  state encoding (`flax.serialization.to_bytes`), written here on `struct`
  because `msgpack` is not known to be installed where the port runs. An
  ndarray is msgpack ext type 1 holding the msgpack array
  `[shape, dtype name, C-order bytes]`; a numpy scalar is ext type 3 with
  the same payload; maps have string keys in sorted order. The bytes
  equal `flax.serialization.msgpack_serialize`'s for trees of dicts,
  arrays, numpy scalars and Python scalars.
"""
from __future__ import annotations

import os
import pickle
import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
MAX_LEAF_BYTES = 2 ** 30  # flax chunks leaves above this (MAX_CHUNK_SIZE)


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):  # a torch tensor
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_pytree(path: str, tree: Any) -> str:
    """Write `tree` (nested dicts of arrays) to `<path>.pkl`; returns that file.

    Both packages read this file. The one difference from JAX's
    `save_pytree`: where orbax is installed, JAX writes an orbax directory
    at `path` instead (which `load_pytree` reads too); the port never does,
    since the card's machine has no orbax."""
    out = os.path.abspath(path) + ".pkl"
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "wb") as f:
        pickle.dump(_to_numpy(tree), f)
    return out


def load_pytree(path: str) -> Any:
    """Read what either package's `save_pytree` wrote: `<path>.pkl`, or the
    orbax directory at `path`."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        return _load_orbax(path)
    if os.path.exists(path + ".pkl"):
        with open(path + ".pkl", "rb") as f:
            return pickle.load(f)
    raise FileNotFoundError(path)


def _load_orbax(path: str) -> Any:
    """An orbax PyTree checkpoint directory, read with tensorstore.

    The tree comes from `_METADATA`'s `tree_metadata`: each leaf's key path
    (`key_type` 2 a dict key, 1 a list index) and value type. Each array leaf
    is a zarr array (zarr3 where `use_zarr3`) in the OCDBT key-value store
    at the path's keys joined by "."; the store must be OCDBT (`use_ocdbt`).
    Leaves come back as orbax restores them: numpy arrays, Python scalars
    for `scalar` leaves, and empty dicts, lists and None where saved."""
    import json

    meta_file = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_file):
        raise FileNotFoundError(f"{path}: a directory without orbax's _METADATA")
    with open(meta_file) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt"):
        raise ValueError(f"{path}: an orbax layout without OCDBT is not read")
    import tensorstore as ts

    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    kvstore = {"driver": "ocdbt", "base": f"file://{path}"}
    empty = {"Dict": dict, "List": list, "None": lambda: None}
    root: dict = {}
    for leaf in meta["tree_metadata"].values():
        keys = leaf["key_metadata"]
        kind = leaf["value_metadata"]["value_type"]
        if kind in empty:
            value = empty[kind]()
        else:
            spec = {"driver": driver, "kvstore": kvstore,
                    "path": ".".join(str(k["key"]) for k in keys)}
            value = ts.open(spec, open=True).result().read().result()
            if kind == "scalar":
                value = value.item()
        node = root
        for k in keys[:-1]:
            node = node.setdefault((k["key"], k["key_type"]), {})
        node[(keys[-1]["key"], keys[-1]["key_type"])] = value
    return _orbax_tree(root)


def _orbax_tree(node: Any) -> Any:
    """Nested {(key, key_type): value} -> dicts, and lists where every key is
    a sequence index (key_type 1)."""
    if not isinstance(node, dict) or not node:
        return node
    if all(kt == 1 for _, kt in node):
        return [_orbax_tree(node[k]) for k in sorted(node, key=lambda k: int(k[0]))]
    return {k: _orbax_tree(v) for (k, _), v in node.items()}


# -- msgpack ---------------------------------------------------------------

def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -32 <= n < 0:
        return struct.pack("b", n)
    if n >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"integer {n} does not fit msgpack")


def _pack_len(n: int, fix: Tuple[int, int] | None, codes) -> bytes:
    """A length header: the fix form (base, limit) or the first wide code
    (code, struct format, largest length) that holds n."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, top in codes:
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARRAY = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF), (0xC9, ">I", 0xFFFFFFFF))


def _pack_ext(code: int, data: bytes) -> bytes:
    n = len(data)
    head = (bytes([_FIXEXT[n]]) if n in _FIXEXT
            else _pack_len(n, None, _EXT))
    return head + struct.pack("b", code) + data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """flax `_ndarray_to_bytes`: msgpack of (shape, dtype name, bytes)."""
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"dtype {arr.dtype} cannot be serialized")
    if arr.nbytes > MAX_LEAF_BYTES:
        raise ValueError(f"an array of {arr.nbytes} bytes needs flax's "
                         "chunked form, which the port does not write")
    return _pack((list(arr.shape), arr.dtype.name,
                  np.ascontiguousarray(arr).tobytes()))


def _pack(obj: Any) -> bytes:
    if obj is None:
        return b"\xc0"
    if obj is True or obj is False:
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, np.ndarray):
        return _pack_ext(_EXT_NDARRAY, _ndarray_payload(obj))
    if isinstance(obj, np.generic):
        return _pack_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    if isinstance(obj, int):
        return _pack_int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _pack_len(len(raw), (0xA0, 32), _STR) + raw
    if isinstance(obj, (bytes, bytearray)):
        return _pack_len(len(obj), None, _BIN) + bytes(obj)
    if isinstance(obj, (list, tuple)):
        return (_pack_len(len(obj), (0x90, 16), _ARRAY)
                + b"".join(_pack(v) for v in obj))
    if isinstance(obj, dict):
        return (_pack_len(len(obj), (0x80, 16), _MAP)
                + b"".join(_pack(k) + _pack(v) for k, v in obj.items()))
    raise TypeError(f"cannot serialize {type(obj).__name__}")


def msgpack_serialize(tree: Any) -> bytes:
    """The msgpack bytes of a tree of dicts with string keys and numpy
    leaves, as `flax.serialization.msgpack_serialize` writes them."""
    return _pack(_state_dict(tree))


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        raw = self.take(n)
        return raw if self.raw else raw.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray_from_payload(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_payload(data)[()]
        raise ValueError(f"msgpack ext type {code} is not a flax array")

    def read(self):
        b = self.unpack("B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        sizes = {0: ">B", 1: ">H", 2: ">I"}
        for base, kind in ((0xC4, "bin"), (0xC7, "ext"), (0xD9, "str")):
            if base <= b <= base + 2:
                n = self.unpack(sizes[b - base])
                if kind == "bin":
                    return self.take(n)
                return self.ext(n) if kind == "ext" else self.str_(n)
        fixext = {v: k for k, v in _FIXEXT.items()}
        if b in fixext:
            return self.ext(fixext[b])
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(
                ">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    reader = _Reader(data, raw=True)
    shape, dtype_name, buf = reader.read()
    dtype = np.dtype(dtype_name.decode())  # bfloat16 needs ml_dtypes: raises
    return np.frombuffer(buf, dtype=dtype).reshape(shape, order="C")


def msgpack_restore(data: bytes) -> Any:
    """Decode `msgpack_serialize` (or flax's) bytes into dicts and arrays."""
    reader = _Reader(data, raw=False)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    if isinstance(tree, dict) and _is_chunked(tree):
        raise ValueError("flax's chunked arrays are not read by the port")
    return tree


def _is_chunked(tree: dict) -> bool:
    return "__msgpack_chunked_array__" in tree or any(
        isinstance(v, dict) and _is_chunked(v) for v in tree.values())


def _state_dict(tree: Any) -> Any:
    """flax `to_state_dict` on nested dicts: string keys, in sorted order as
    JAX's tree functions rebuild a dict, numpy leaves."""
    if isinstance(tree, dict):
        items = sorted((str(k), v) for k, v in tree.items())
        return {k: _state_dict(v) for k, v in items}
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return tree


def _restore(template: Any, state: Any, path: str = "") -> Any:
    """flax `from_state_dict` on nested dicts: the template's keys (a missing
    one raises; extra ones in the file are ignored), the file's leaves."""
    if isinstance(template, dict):
        if not isinstance(state, dict):
            raise ValueError(f"{path or '/'}: expected a map in the file")
        missing = [str(k) for k in template if str(k) not in state]
        if missing:
            raise ValueError(f"{path or '/'}: the file lacks keys {missing}")
        return {k: _restore(v, state[str(k)], f"{path}/{k}")
                for k, v in template.items()}
    return state


def save_state_bytes(path: str, state: Any) -> None:
    """Write `state` (nested dicts of arrays, tensors or scalars) as flax
    msgpack state bytes (JAX io.py:34-41): every leaf as an array first, as
    JAX's `_to_numpy` does, so a scalar is a 0-d array in the file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack_serialize(_to_numpy(state)))


def load_state_bytes(path: str, template: Any) -> Any:
    """Restore state bytes into the template's structure (JAX io.py:44-48):
    nested dicts whose leaves are the file's numpy arrays."""
    with open(path, "rb") as f:
        return _restore(template, msgpack_restore(f.read()))
