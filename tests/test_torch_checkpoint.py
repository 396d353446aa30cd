"""Checkpoint interop between the JAX package and the PyTorch port.

Both packages write the same safetensors files: a file written by either
loads byte-exact in the other (f32, bf16 and int leaves, nested paths,
JSON metadata). The port's writer is hand-written (numpy + json + struct).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import checkpoint as tck
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import trees as ttrees
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import checkpoint as jck
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import trees as jtrees

META = {"step": 7, "model": "vit_test", "vocab": ["a", "b"], "cfg": {"rank": 8}}


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "blocks": {"attn": {"q": {"w": rng.standard_normal((2, 4, 3)).astype(np.float32),
                                  "b": rng.standard_normal((2, 3)).astype(np.float32)}}},
        "bf": {"x": rng.standard_normal((5, 2)).astype(np.float32)},  # stored as bf16
        "count": np.arange(6, dtype=np.int32).reshape(2, 3),
        "mask": np.array([1, 0, 255], np.uint8),
    }


def _bits(leaf) -> bytes:
    """Raw bytes of a leaf from either package (bf16 by its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    a = np.asarray(leaf)
    if a.dtype == jnp.bfloat16:
        a = a.view(np.uint16)
    return np.ascontiguousarray(a).tobytes()


def test_jax_file_loads_byte_exact_in_port(tmp_path):
    tree = _np_tree()
    jtree = jtrees.unflatten_from_paths(
        {p: (jnp.asarray(v, jnp.bfloat16) if p.startswith("bf/") else jnp.asarray(v))
         for p, v in jtrees.flatten_with_paths(tree).items()})
    path = str(tmp_path / "jax.safetensors")
    jck.save_pytree(jtree, path, meta=META)
    got, meta = tck.load_pytree(path)
    assert meta == META
    want = jtrees.flatten_with_paths(jtree)
    flat = ttrees.flatten_with_paths(got)
    assert set(flat) == set(want)
    assert flat["bf/x"].dtype == torch.bfloat16
    for p in want:
        assert tuple(flat[p].shape) == tuple(want[p].shape), p
        assert _bits(flat[p]) == _bits(want[p]), p


def test_port_file_loads_byte_exact_in_jax(tmp_path):
    tree = ttrees.map_leaves(torch.from_numpy, _np_tree(1))
    tree["bf"]["x"] = tree["bf"]["x"].to(torch.bfloat16)
    # a transposed (non-contiguous) view must be written as the matrix it shows
    tree["blocks"]["attn"]["t"] = torch.arange(12.0).reshape(3, 4).t()
    path = str(tmp_path / "port.safetensors")
    tck.save_pytree(tree, path, meta=META)
    got, meta = jck.load_pytree(path)
    assert meta == META
    flat = jtrees.flatten_with_paths(got)
    want = ttrees.flatten_with_paths(tree)
    assert set(flat) == set(want)
    assert flat["bf/x"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(flat["blocks/attn/t"], np.arange(12.0).reshape(3, 4).T)
    for p in want:
        assert tuple(flat[p].shape) == tuple(want[p].shape), p
        assert _bits(flat[p]) == _bits(want[p]), p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int64])
def test_port_round_trip(tmp_path, dtype):
    t = (torch.randn(3, 5, generator=torch.Generator().manual_seed(0)) * 100).to(dtype)
    path = str(tmp_path / "rt.safetensors")
    tck.save_pytree({"a": {"b": t}, "s": torch.tensor(2.5)}, path)
    got, meta = tck.load_pytree(path)
    assert meta == {}
    assert got["a"]["b"].dtype == dtype and torch.equal(got["a"]["b"], t)
    assert got["s"].shape == () and float(got["s"]) == 2.5


def test_port_file_header_layout(tmp_path):
    """8-byte little-endian length, JSON header padded to a multiple of 8."""
    import json
    import struct

    path = str(tmp_path / "h.safetensors")
    tck.save_pytree({"w": torch.ones(3)}, path, meta={"k": 1})
    data = open(path, "rb").read()
    (n,) = struct.unpack("<Q", data[:8])
    assert n % 8 == 0 and len(data) == 8 + n + 12
    header = json.loads(data[8:8 + n])
    assert header["w"] == {"dtype": "F32", "shape": [3], "data_offsets": [0, 12]}
    assert json.loads(header["__metadata__"]["apvt_meta"]) == {"k": 1}


def test_trees_helpers_match_jax():
    tree = _np_tree(2)
    flat = ttrees.flatten_with_paths(tree)
    assert list(flat) == list(jtrees.flatten_with_paths(tree))
    back = ttrees.unflatten_from_paths(flat)
    assert ttrees.flatten_with_paths(back).keys() == flat.keys()
    for p in flat:
        assert back is not tree
        assert ttrees.get_path(back, p) is flat[p]
        assert ttrees.get_path(tree, p) is jtrees.get_path(tree, p)
    sub = ttrees.get_path(tree, "blocks/attn/q")
    assert set(sub) == {"w", "b"}
    upd = ttrees.update_path(tree, "blocks/attn/q", lambda d: {**d, "extra": 1})
    assert "extra" in upd["blocks"]["attn"]["q"] and "extra" not in tree["blocks"]["attn"]["q"]
    assert ttrees.set_path(tree, "count", 3)["count"] == 3
    assert isinstance(tree["count"], np.ndarray)
    with pytest.raises(KeyError):
        ttrees.get_path(tree, "count/deeper")
