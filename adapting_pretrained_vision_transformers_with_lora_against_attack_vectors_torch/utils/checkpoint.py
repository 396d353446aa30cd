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

:func:`save_tensors` / :func:`load_tensors` read and write a flat map of
named tensors in the same format (bf16 under the format's own ``BF16`` tag),
for files such as PEFT adapters. Writes are atomic (temp file in the same
directory, then ``os.replace``).
Every leaf is made C-contiguous before its raw bytes are written: a strided
view would otherwise be written as the wrong matrix.

:func:`save_train_state` / :func:`load_train_state` write and read a resume
file of the port's own: a torch optimizer's state is not an optax tree, so
these files are not exchanged with the JAX package (model checkpoints are).
Under a mesh (the state's, ``parallel.mesh``) the save gathers the model-axis
slices and global rank 0 writes the file a single-process run writes; the
load reads the whole file on every rank, which keeps its slices.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..parallel import mesh as pmesh
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
    """Leaf -> (C-contiguous array, was_bf16); bf16 comes back as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy(), True
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return np.array(arr, order="C", copy=not arr.flags.c_contiguous), False


def save_tensors(tensors: Mapping[str, Any], path: str, *,
                 metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write a flat ``{name: tensor or array}`` map as a safetensors file,
    atomically. bf16 tensors are stored under the format's own ``BF16`` tag."""
    arrays, tags = {}, {}
    for name, leaf in tensors.items():
        arrays[name], is_bf16 = _to_numpy(leaf)
        if is_bf16:
            tags[name] = "BF16"
        elif arrays[name].dtype in _TAG_OF:
            tags[name] = _TAG_OF[arrays[name].dtype]
        else:
            raise TypeError(f"{name}: dtype {arrays[name].dtype} has no safetensors tag")
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name in sorted(arrays):
        a = arrays[name]
        header[name] = {"dtype": tags[name], "shape": list(a.shape),
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


def load_tensors(path: str) -> tuple[dict[str, torch.Tensor], dict[str, str]]:
    """Read a safetensors file: ``({name: CPU tensor}, metadata)``."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    base = 8 + n
    metadata = header.pop("__metadata__", None) or {}
    flat = {}
    for name, info in header.items():
        start, end = info["data_offsets"]
        bf16 = info["dtype"] == "BF16"
        dt = np.dtype(np.uint16) if bf16 else _DTYPE_OF[info["dtype"]]
        arr = np.frombuffer(data, dtype=dt, count=(end - start) // dt.itemsize,
                            offset=base + start).reshape(info["shape"]).copy()
        t = torch.from_numpy(arr)
        flat[name] = t.view(torch.bfloat16) if bf16 else t
    return flat, metadata


def save_pytree(tree, path: str, *, meta: Optional[dict] = None) -> None:
    """Save a dict tree of tensors/arrays to ``path`` (.safetensors) atomically."""
    arrays, bf16_paths = {}, []
    for p, leaf in trees.flatten_with_paths(tree).items():
        arrays[p], is_bf16 = _to_numpy(leaf)
        if is_bf16:
            bf16_paths.append(p)
    sidecar = dict(meta or {})
    if bf16_paths:
        sidecar[_BF16_TAG] = bf16_paths
    save_tensors(arrays, path, metadata={_META_KEY: json.dumps(sidecar, default=str)})


def load_pytree(path: str) -> tuple[Any, dict]:
    """Load ``(tree, meta)``; leaves are CPU torch tensors (bf16 restored)."""
    flat, raw_meta = load_tensors(path)
    meta = json.loads(raw_meta[_META_KEY]) if _META_KEY in raw_meta else {}
    for name in meta.pop(_BF16_TAG, []):
        flat[name] = flat[name].view(torch.bfloat16)
    return trees.unflatten_from_paths(flat), meta


def save_train_state(state, path_prefix: str, *, meta: Optional[dict] = None) -> None:
    """Persist a ``train.steps.TrainState`` as one atomic
    ``{prefix}.state.safetensors``: the trainable tensors under ``params/``
    by name, the optimizer's per-tensor state under ``opt/<position>/``, the
    update count in the metadata. Under a mesh every rank must call it (the
    model-axis slices are gathered); rank 0 writes."""
    m = dict(meta or {})
    m["step"] = int(state.step)
    flat, dims = {}, {}
    for i, (name, p) in enumerate(state.trainable.items()):
        flat[f"params/{name}"] = p.detach()
        for k, v in state.optimizer.state.get(p, {}).items():
            if isinstance(v, torch.Tensor):
                flat[f"opt/{i:05d}/{k}"] = v
                if name in state.shard_dims and v.shape == p.shape:
                    dims[f"opt/{i:05d}/{k}"] = state.shard_dims[name]
        if name in state.shard_dims:
            dims[f"params/{name}"] = state.shard_dims[name]
    flat = pmesh.gather_dims(state.mesh, flat, dims)
    if pmesh.is_main(state.mesh):
        save_pytree(trees.unflatten_from_paths(flat), path_prefix + ".state.safetensors", meta=m)


def train_state_exists(path_prefix: str) -> bool:
    return os.path.exists(path_prefix + ".state.safetensors")


def load_train_state(path_prefix: str, state) -> dict:
    """Load a resume file into ``state`` in place (parameters, optimizer
    moments, update count); returns the metadata. The state must name the
    tensors the saved one named; under a mesh each rank keeps its slices."""
    tree, meta = load_pytree(path_prefix + ".state.safetensors")
    mr, ms = (pmesh.axis_rank(state.mesh, pmesh.MODEL_AXIS),
              pmesh.axis_size(state.mesh, pmesh.MODEL_AXIS))

    def mine(name, t):
        d = state.shard_dims.get(name)
        if d is None or t.ndim == 0:
            return t
        n = t.shape[d] // ms
        return t.narrow(d, mr * n, n)

    saved = tree["params"]
    if set(saved) != set(state.trainable):
        raise ValueError("the resume file names other tensors than this run trains: "
                         f"{sorted(set(saved) ^ set(state.trainable))[:4]}")
    opt_state = {}
    with torch.no_grad():
        for i, (name, p) in enumerate(state.trainable.items()):
            p.copy_(mine(name, saved[name]).to(p.device, p.dtype))
            entry = tree.get("opt", {}).get(f"{i:05d}")
            if entry:
                # the update count stays where the optimizer keeps it (the host, by default)
                opt_state[i] = {k: v if k == "step" else mine(name, v).to(p.device)
                                for k, v in entry.items()}
    current = state.optimizer.state_dict()
    state.optimizer.load_state_dict({"state": opt_state, "param_groups": current["param_groups"]})
    state.step = int(meta.get("step", 0))
    return meta
