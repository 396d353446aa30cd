"""The port's ``ops/nn.py`` and ``ops/lora.py`` against the JAX package.

Same numpy inputs (from a seed) into both; f32 on the CPU; atol 1e-6,
rtol 1e-5 (summation order differs between the two frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import lora as tlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import nn as tnn
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import trees as ttrees
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import lora as jlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import nn as jnn
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import trees as jtrees

ATOL, RTOL = 1e-6, 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _both(tree):
    """numpy tree -> (jax tree, torch tree)."""
    flat = jtrees.flatten_with_paths(tree)
    return (jtrees.unflatten_from_paths({p: jnp.asarray(v) for p, v in flat.items()}),
            ttrees.unflatten_from_paths({p: torch.from_numpy(np.array(v)) for p, v in flat.items()}))


def _both_adapter(adapter):
    """numpy adapter ({target path: {"a", "b"}}) -> (jax adapter, torch adapter)."""
    return ({p: {k: jnp.asarray(v) for k, v in fac.items()} for p, fac in adapter.items()},
            {p: {k: torch.from_numpy(v.copy()) for k, v in fac.items()}
             for p, fac in adapter.items()})


def _close(t, j, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.detach().numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), atol=atol, rtol=rtol)


def _stacked_params(rng, depth=2, d=8, m=12):
    f = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.3
    return {"blocks": {"attn": {t: {"w": f(depth, d, d), "b": f(depth, d)} for t in "qkvo"},
                       "mlp": {"fc1": {"w": f(depth, d, m), "b": f(depth, m)}}},
            "head": {"w": f(d, 3), "b": f(3)}}


@pytest.mark.parametrize("bias", [True, False])
def test_dense_plain(bias):
    rng = _rng(1)
    p = {"w": rng.standard_normal((16, 24)).astype(np.float32)}
    if bias:
        p["b"] = rng.standard_normal(24).astype(np.float32)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    jp, tp = _both(p)
    _close(tnn.dense(tp, torch.from_numpy(x)), jnn.dense(jp, jnp.asarray(x)))


def test_dense_with_attached_lora():
    rng = _rng(2)
    params = _stacked_params(rng)
    cfg_j = jlora.LoRAConfig(rank=4, alpha=16.0, targets=("blocks/attn/q", "head"))
    cfg_t = tlora.LoRAConfig(rank=4, alpha=16.0, targets=cfg_j.targets)
    adapter = {"blocks/attn/q": {"a": rng.standard_normal((2, 8, 4)).astype(np.float32),
                                 "b": rng.standard_normal((2, 4, 8)).astype(np.float32)},
               "head": {"a": rng.standard_normal((8, 4)).astype(np.float32),
                        "b": rng.standard_normal((4, 3)).astype(np.float32)}}
    (jp, tp), (ja, ta) = _both(params), _both_adapter(adapter)
    j_att, t_att = jlora.attach(jp, ja, cfg_j), tlora.attach(tp, ta, cfg_t)
    assert set(ttrees.flatten_with_paths(t_att)) == set(jtrees.flatten_with_paths(j_att))
    x = rng.standard_normal((4, 8)).astype(np.float32)
    _close(tnn.dense(t_att["head"], torch.from_numpy(x)), jnn.dense(j_att["head"], jnp.asarray(x)))
    layer = lambda tree, i: {k: v[i] for k, v in tree["blocks"]["attn"]["q"].items()}
    for i in range(2):
        _close(tnn.dense(layer(t_att, i), torch.from_numpy(x)),
               jnn.dense(layer(j_att, i), jnp.asarray(x)))


@pytest.mark.parametrize("scale", [1.0, 1e-3, 50.0])
def test_layer_norm_eps_1e12(scale):
    rng = _rng(3)
    x = (rng.standard_normal((2, 7, 32)) * scale).astype(np.float32)
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    jp, tp = _both(p)
    _close(tnn.layer_norm(tp, torch.from_numpy(x), eps=1e-12),
           jnn.layer_norm(jp, jnp.asarray(x), eps=1e-12), atol=1e-5)


def test_gelu_exact():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    _close(tnn.gelu(torch.from_numpy(x)), jnn.gelu(jnp.asarray(x)))


def test_attention_plain_matches_jax():
    rng = _rng(4)
    q, k, v = (rng.standard_normal((2, 3, 11, 16)).astype(np.float32) for _ in range(3))
    _close(tnn.attention(*map(torch.from_numpy, (q, k, v))),
           jnn.attention(*map(jnp.asarray, (q, k, v))))


def test_lora_init_shapes_match_jax():
    params = _stacked_params(_rng(5))
    targets = ("blocks/attn/q", "blocks/attn/v", "blocks/mlp/fc1", "head")
    jp, tp = _both(params)
    ja = jlora.init(jax.random.key(0), jp, jlora.LoRAConfig(rank=4, targets=targets))
    ta = tlora.init(torch.Generator().manual_seed(0), tp, tlora.LoRAConfig(rank=4, targets=targets))
    assert list(ta) == list(ja)
    for path in targets:
        for f in ("a", "b"):
            assert tuple(ta[path][f].shape) == ja[path][f].shape
        assert not ta[path]["b"].any()
        bound = (1.0 / ta[path]["a"].shape[-2]) ** 0.5
        assert float(ta[path]["a"].abs().max()) <= bound


def _adapter(rng, params, targets, rank=4):
    out = {}
    for path in targets:
        w = jtrees.get_path(params, path)["w"]
        *lead, di, do = w.shape
        out[path] = {"a": rng.standard_normal((*lead, di, rank)).astype(np.float32) * 0.2,
                     "b": rng.standard_normal((*lead, rank, do)).astype(np.float32) * 0.2}
    return out


def test_lora_delta_and_merge_match_jax():
    rng = _rng(6)
    params = _stacked_params(rng)
    targets = ("blocks/attn/q", "blocks/attn/o", "head")
    cj, ct = (jlora.LoRAConfig(rank=4, alpha=8.0, targets=targets),
              tlora.LoRAConfig(rank=4, alpha=8.0, targets=targets))
    (jp, tp), (ja, ta) = _both(params), _both_adapter(_adapter(rng, params, targets))
    for path in targets:
        _close(tlora.delta(ta[path], ct.scale), jlora.delta(ja[path], cj.scale))
    tm, jm = tlora.merge(tp, ta, ct), jlora.merge(jp, ja, cj)
    for p, v in jtrees.flatten_with_paths(jm).items():
        _close(ttrees.get_path(tm, p), v)
    # un-merge restores the base weights; the inputs were never modified
    back = tlora.merge(tm, ta, ct, sign=-1.0)
    for p, v in ttrees.flatten_with_paths(tp).items():
        _close(ttrees.get_path(back, p), v.numpy(), atol=1e-6)
        assert torch.equal(v, torch.from_numpy(np.array(ttrees.get_path(params, p))))


def test_lora_merge_many_matches_jax():
    rng = _rng(7)
    params = _stacked_params(rng)
    targets = ("blocks/attn/k", "blocks/attn/v")
    ads = [_adapter(rng, params, targets, rank=r) for r in (2, 4)]
    cfg_pairs = [(jlora.LoRAConfig(rank=r, alpha=16.0, targets=targets),
                  tlora.LoRAConfig(rank=r, alpha=16.0, targets=targets)) for r in (2, 4)]
    jp, tp = _both(params)
    jm = jlora.merge_many(jp, [_both_adapter(a)[0] for a in ads], [c[0] for c in cfg_pairs])
    tm = tlora.merge_many(tp, [_both_adapter(a)[1] for a in ads], [c[1] for c in cfg_pairs])
    for p, v in jtrees.flatten_with_paths(jm).items():
        _close(ttrees.get_path(tm, p), v)


def test_lora_attach_detach_round_trip():
    rng = _rng(8)
    params = _stacked_params(rng)
    targets = ("blocks/attn/q", "head")
    cfg = tlora.LoRAConfig(rank=4, targets=targets)
    tp = _both(params)[1]
    att = tlora.attach(tp, _both_adapter(_adapter(rng, params, targets))[1], cfg)
    q = att["blocks"]["attn"]["q"]
    assert q["lora_s"].shape == (2,) and torch.all(q["lora_s"] == cfg.scale)
    assert att["head"]["lora_s"].shape == ()
    det = tlora.detach(att)
    assert set(ttrees.flatten_with_paths(det)) == set(ttrees.flatten_with_paths(tp))
    assert "lora_a" not in tp["head"]
