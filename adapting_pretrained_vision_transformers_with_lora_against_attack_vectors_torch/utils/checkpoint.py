"""Pytree checkpoints in the safetensors file format, written by hand.

Files are interchangeable with the JAX package's ``utils/checkpoint.py``
(``save_pytree`` / ``load_pytree``) and need only numpy, ``json`` and
``struct``:

* an 8-byte little-endian header length, then a JSON header padded with
  spaces to a multiple of 8, then the raw C-order bytes of every tensor;
* each tensor's header entry gives its dtype tag, shape and byte offsets;
* non-tensor metadata is one JSON string under the ``apvt_meta`` key of the
  header's ``__metadata__`` map;
* bfloat16 leaves are bit-cast to uint16 and listed under ``__bf16__`` in
  that metadata, as the JAX package does.

Writes are atomic (temp file in the same directory, then ``os.replace``).
Every leaf is made C-contiguous before its raw bytes are written: a strided
view would otherwise be written as the wrong matrix.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from . import trees

_BF16_TAG = "__bf16__"
_META_KEY = "apvt_meta"

_TAG_OF = {np.dtype(np.float64): "F64", np.dtype(np.float32): "F32",
           np.dtype(np.float16): "F16", np.dtype(np.int64): "I64",
           np.dtype(np.int32): "I32", np.dtype(np.int16): "I16",
           np.dtype(np.int8): "I8", np.dtype(np.uint64): "U64",
           np.dtype(np.uint32): "U32", np.dtype(np.uint16): "U16",
           np.dtype(np.uint8): "U8", np.dtype(np.bool_): "BOOL"}
_DTYPE_OF = {tag: dt for dt, tag in _TAG_OF.items()}


def _to_numpy(leaf) -> tuple[np.ndarray, bool]:
    """Leaf -> (C-contiguous array, was_bf16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy(), True
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return np.array(arr, order="C", copy=not arr.flags.c_contiguous), False


def save_pytree(tree, path: str, *, meta: Optional[dict] = None) -> None:
    """Save a dict tree of tensors/arrays to ``path`` (.safetensors) atomically."""
    flat = trees.flatten_with_paths(tree)
    arrays, bf16_paths = {}, []
    for p, leaf in flat.items():
        arrays[p], is_bf16 = _to_numpy(leaf)
        if is_bf16:
            bf16_paths.append(p)
    sidecar = dict(meta or {})
    if bf16_paths:
        sidecar[_BF16_TAG] = bf16_paths

    header: dict[str, Any] = {
        "__metadata__": {_META_KEY: json.dumps(sidecar, default=str)}}
    offset = 0
    for name in sorted(arrays):
        a = arrays[name]
        if a.dtype not in _TAG_OF:
            raise TypeError(f"{name}: dtype {a.dtype} has no safetensors tag")
        header[name] = {"dtype": _TAG_OF[a.dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)

    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(struct.pack("<Q", len(blob)))
            f.write(blob)
            for name in sorted(arrays):
                f.write(arrays[name].tobytes(order="C"))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_pytree(path: str) -> tuple[Any, dict]:
    """Load ``(tree, meta)``; leaves are CPU torch tensors (bf16 restored)."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    base = 8 + n
    raw_meta = header.pop("__metadata__", None) or {}
    meta = json.loads(raw_meta[_META_KEY]) if _META_KEY in raw_meta else {}
    bf16 = set(meta.pop(_BF16_TAG, []))
    flat = {}
    for name, info in header.items():
        start, end = info["data_offsets"]
        dt = _DTYPE_OF[info["dtype"]]
        arr = np.frombuffer(data, dtype=dt, count=(end - start) // dt.itemsize,
                            offset=base + start).reshape(info["shape"]).copy()
        t = torch.from_numpy(arr)
        if name in bf16:
            t = t.view(torch.bfloat16)
        flat[name] = t
    return trees.unflatten_from_paths(flat), meta
