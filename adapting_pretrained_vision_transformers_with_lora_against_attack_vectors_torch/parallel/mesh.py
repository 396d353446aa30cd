"""Device mesh and placement over ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``. A JAX mesh is one
program over many devices; here every rank is a process of its own and all
ranks run the same code over a ``DeviceMesh`` with dims ``("data",
"model")`` (:func:`make_mesh`, over the process group the caller or
:mod:`.launch` initialized):

* ``data``: each rank holds its rows of the global batch
  (:func:`shard_batch`); the train step's loss divides by the global valid
  count, gradients and metrics are summed over this axis, and every random
  draw is the draw over the global batch, of which a rank keeps its rows
  (:func:`data_rows`), so a sharded run is the single-process run at the
  same seed;
* ``model``: tensor parallelism by the JAX package's rules
  (:func:`vit_param_rules`): q/k/v and fc1 split on the output dim, o and
  fc2 on the input dim, each half-block one all-reduce (:mod:`.tp`).

A placement is a tuple of axis names or ``None``, one per dim, as a JAX
``PartitionSpec`` reads (``()`` = replicated). With a model axis of 1 every
placement is replicated, so pure data parallelism and DP x TP share one code
path. The param trees at every boundary keep the full JAX layout: a module
built under a mesh holds this rank's slices (:func:`shard_tree`) and gives
the full tree back (:func:`gather_tree`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist

from ..utils import trees

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data: int = -1  # -1: all remaining ranks
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = self.model
        data = self.data if self.data != -1 else n_devices // model
        if data * model != n_devices:
            raise ValueError(f"mesh {data}x{model} != {n_devices} devices")
        return data, model


def make_mesh(spec: MeshSpec = MeshSpec(), *, device):
    """A ``DeviceMesh`` of shape ``spec.resolve(world size)`` over the
    initialized default process group, ranks laid out row-major (a model
    group is consecutive ranks). ``device`` is ``"cuda"`` or ``"cpu"``; a
    CUDA mesh without CUDA raises."""
    from torch.distributed.device_mesh import DeviceMesh

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: device 'cuda' asked for but CUDA is not available")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call torch.distributed."
                           "init_process_group (or run under parallel.launch.spawn) first")
    data, model = spec.resolve(dist.get_world_size())
    return DeviceMesh(device.type, torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else int(mesh.get_local_rank(mesh.mesh_dim_names.index(axis)))


def axis_group(mesh, axis: str):
    return mesh.get_group(mesh.mesh_dim_names.index(axis))


def is_main(mesh) -> bool:
    """True on the rank that logs and writes files: global rank 0, or the
    only process without a mesh."""
    return mesh is None or dist.get_rank() == 0


def mesh_of(module) -> Any:
    """The mesh a model was built on (``from_tree(..., mesh=)``), or None."""
    return getattr(module, "mesh", None)


def batch_sharding(mesh, ndim: int = 4) -> tuple:
    """Leading axis over 'data', rest replicated (NHWC images, labels, ...)."""
    return (DATA_AXIS, *([None] * (ndim - 1)))


def replicated(mesh) -> tuple:
    return ()


def data_rows(mesh, n: int) -> tuple[int, slice]:
    """``(global rows, this rank's slice of them)`` for a local batch of
    ``n`` rows: a draw over the global batch, sliced, is this rank's part of
    the single-process draw."""
    d, r = axis_size(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS)
    return n * d, slice(r * n, (r + 1) * n)


def shard_batch(mesh, *arrays):
    """This rank's rows of each array along the data axis (numpy arrays or
    tensors, sliced, not copied); rank-0 arrays (scalars riding along with a
    batch) are returned whole. A leading dim the data axis does not divide
    raises, as JAX's ``device_put`` does."""
    d, r = axis_size(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS)
    out = []
    for a in arrays:
        if a.ndim == 0:
            out.append(a)
            continue
        n = a.shape[0]
        if n % d:
            raise ValueError(f"a batch of {n} rows does not divide over the data axis of size {d}")
        out.append(a[r * n // d:(r + 1) * n // d])
    return tuple(out) if len(out) > 1 else out[0]


def all_reduce(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum ``t`` over ``axis`` in place (nothing on an axis of 1); returns it."""
    if axis_size(mesh, axis) > 1:
        dist.all_reduce(t, group=axis_group(mesh, axis))
    return t


def gather_rows(mesh, *tensors):
    """Each tensor's rows from every rank of the data axis, in rank order:
    the global batch (identity on an axis of 1)."""
    d = axis_size(mesh, DATA_AXIS)
    out = []
    for t in tensors:
        if d > 1:
            parts = [torch.empty_like(t) for _ in range(d)]
            dist.all_gather(parts, t.contiguous(), group=axis_group(mesh, DATA_AXIS))
            t = torch.cat(parts)
        out.append(t)
    return tuple(out) if len(out) > 1 else out[0]


# --- tensor-parallel parameter layout rules ---------------------------------

# (path regex, placement given leaf ndim). Stacked ViT blocks give kernels
# shape (L, in, out) and biases (L, dim); unstacked leaves have no L.
def vit_param_rules() -> list[tuple[str, dict[int, tuple]]]:
    col = {3: (None, None, MODEL_AXIS), 2: (None, MODEL_AXIS)}  # split out dim
    row = {3: (None, MODEL_AXIS, None), 2: (MODEL_AXIS, None)}  # split in dim
    col_bias = {2: (None, MODEL_AXIS), 1: (MODEL_AXIS,)}
    return [
        (r".*attn/(q|k|v)/w$", col),
        (r".*attn/(q|k|v)/b$", col_bias),
        (r".*attn/(q|k|v)/lora_b$", col),
        (r".*attn/o/w$", row),
        (r".*attn/o/lora_a$", row),
        (r".*mlp/fc1/w$", col),
        (r".*mlp/fc1/b$", col_bias),
        (r".*mlp/fc1/lora_b$", col),
        (r".*mlp/fc2/w$", row),
        (r".*mlp/fc2/lora_a$", row),
    ]


def _is_flat(tree) -> bool:
    return isinstance(tree, Mapping) and not any(isinstance(v, Mapping) for v in tree.values())


def _flat_placements(mesh, flat: Mapping[str, Any], rules) -> dict[str, tuple]:
    rules = vit_param_rules() if rules is None else rules
    compiled = [(re.compile(pat), specs) for pat, specs in rules]
    out = {}
    for path, leaf in flat.items():
        spec = ()
        if axis_size(mesh, MODEL_AXIS) > 1:
            for pat, specs in compiled:
                if pat.match(path) and leaf.ndim in specs:
                    spec = specs[leaf.ndim]
                    break
        out[path] = spec
    return out


def tree_shardings(mesh, tree, rules: Optional[list] = None):
    """Placement tree for ``tree``: rule match or fully replicated. When the
    mesh's model axis is 1 (or there is no mesh) every placement is ``()``."""
    placed = _flat_placements(mesh, trees.flatten_with_paths(tree), rules)
    return placed if _is_flat(tree) else trees.unflatten_from_paths(placed)


def model_dims(mesh, tree, rules: Optional[list] = None) -> dict[str, int]:
    """``{path: dim}`` of the leaves split over the model axis."""
    placed = _flat_placements(mesh, trees.flatten_with_paths(tree), rules)
    return {p: spec.index(MODEL_AXIS) for p, spec in placed.items() if MODEL_AXIS in spec}


def shard_tree(mesh, tree, rules: Optional[list] = None):
    """A full JAX-layout tree (flat or nested) -> this rank's slices of it,
    in the same nesting: a leaf split over the model axis keeps its chunk
    (a dim the axis does not divide raises), every other leaf stays whole."""
    flat = trees.flatten_with_paths(tree)
    m, r = axis_size(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS)
    out = dict(flat)
    for path, dim in model_dims(mesh, flat, rules).items():
        leaf = flat[path]
        size = leaf.shape[dim]
        if size % m:
            raise ValueError(f"{path}: dim {dim} of {tuple(leaf.shape)} does not divide over "
                             f"the model axis of size {m}")
        out[path] = leaf[(slice(None),) * dim + (slice(r * size // m, (r + 1) * size // m),)]
    return out if _is_flat(tree) else trees.unflatten_from_paths(out)


def gather_dims(mesh, flat: Mapping[str, torch.Tensor], dims: Mapping[str, int]) -> dict:
    """``flat`` with each leaf named in ``dims`` all-gathered over the model
    axis along its dim (every rank of the model group gets the whole leaf)."""
    m = axis_size(mesh, MODEL_AXIS)
    out = dict(flat)
    if m == 1:
        return out
    group = axis_group(mesh, MODEL_AXIS)
    for path, dim in dims.items():
        t = flat[path].contiguous()
        parts = [torch.empty_like(t) for _ in range(m)]
        dist.all_gather(parts, t, group=group)
        out[path] = torch.cat(parts, dim=dim)
    return out


def gather_tree(mesh, tree, rules: Optional[list] = None):
    """Inverse of :func:`shard_tree`: this rank's slices -> the full tree
    (a collective over the model group: every rank of it must call it)."""
    flat = trees.flatten_with_paths(tree)
    out = gather_dims(mesh, flat, model_dims(mesh, flat, rules))
    return out if _is_flat(tree) else trees.unflatten_from_paths(out)


def require_replicated(mesh, flat: Mapping[str, Any], what: str) -> None:
    """Raise if any rule splits a leaf of ``flat``: for the backbones whose
    modules hold every parameter whole under a model axis."""
    split = sorted(model_dims(mesh, flat))
    if split:
        raise NotImplementedError(f"{what} has no tensor-parallel module, but the rules split "
                                  f"{split[:3]}")
