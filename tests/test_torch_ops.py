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


def _bf16_pair(x):
    """f32 numpy -> (jax bf16, torch bf16) holding the same values."""
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def test_dense_unmerged_lora_rounds_once_like_jax():
    """x@W stays f32 until the single final rounding: 1 + 2^-8 + 2^-12 - 2^-9
    rounds to 1.0 at bf16 (rounding x@W first gives 1.0078125)."""
    x = np.array([[1.0, 2.0 ** -8, 2.0 ** -12]], np.float32)
    p = {"w": np.ones((3, 1), np.float32), "b": np.array([-2.0 ** -9], np.float32),
         "lora_a": np.zeros((3, 2), np.float32), "lora_b": np.zeros((2, 1), np.float32)}
    jp = {k: _bf16_pair(v)[0] for k, v in p.items()}
    tp = {k: _bf16_pair(v)[1] for k, v in p.items()}
    jp["lora_s"], tp["lora_s"] = jnp.float32(2.0), torch.tensor(2.0)
    want = jnn.dense(jp, _bf16_pair(x)[0])
    got = tnn.dense(tp, _bf16_pair(x)[1])
    assert got.dtype == torch.bfloat16
    assert float(want[0, 0]) == 1.0 and float(got[0, 0]) == 1.0


def test_dense_unmerged_lora_bf16_random_within_one_ulp():
    """Random bf16 inputs: the port's unmerged-LoRA dense equals the JAX
    dense within one bf16 ulp (f32 sums in another order may flip a tie)."""
    rng = _rng(9)
    p = {"w": rng.standard_normal((64, 48)).astype(np.float32) * 0.2,
         "b": rng.standard_normal(48).astype(np.float32),
         "lora_a": rng.standard_normal((64, 4)).astype(np.float32) * 0.2,
         "lora_b": rng.standard_normal((4, 48)).astype(np.float32) * 0.2}
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    jp = {k: _bf16_pair(v)[0] for k, v in p.items()}
    tp = {k: _bf16_pair(v)[1] for k, v in p.items()}
    jp["lora_s"], tp["lora_s"] = jnp.float32(4.0), torch.tensor(4.0)
    want = np.asarray(jnn.dense(jp, _bf16_pair(x)[0]).astype(jnp.float32))
    got = tnn.dense(tp, _bf16_pair(x)[1]).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp)
    assert np.mean(got == want) > 0.99


def test_lora_merge_broadcasts_swin_pair_axes():
    """Swin factors carry (pairs, 2) lead axes; init, merge and merge_many
    broadcast over both, as the JAX einsum does."""
    rng = _rng(10)
    f = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.3
    params = {"stages": {"0": {"blocks": {"attn": {"qkv": {"w": f(3, 2, 8, 24), "b": f(3, 2, 24)},
                                                   "proj": {"w": f(3, 2, 8, 8)}}}}}}
    targets = ("stages/0/blocks/attn/qkv", "stages/0/blocks/attn/proj")
    jp, tp = _both(params)
    ta0 = tlora.init(torch.Generator().manual_seed(0), tp, tlora.LoRAConfig(rank=4, targets=targets))
    assert tuple(ta0[targets[0]]["a"].shape) == (3, 2, 8, 4)
    assert tuple(ta0[targets[0]]["b"].shape) == (3, 2, 4, 24)
    ads = [_adapter(rng, params, targets, rank=r) for r in (2, 4)]
    cfgs = [(jlora.LoRAConfig(rank=r, alpha=16.0, targets=targets),
             tlora.LoRAConfig(rank=r, alpha=16.0, targets=targets)) for r in (2, 4)]
    jm = jlora.merge_many(jp, [_both_adapter(a)[0] for a in ads], [c[0] for c in cfgs])
    tm = tlora.merge_many(tp, [_both_adapter(a)[1] for a in ads], [c[1] for c in cfgs])
    for p, v in jtrees.flatten_with_paths(jm).items():
        _close(ttrees.get_path(tm, p), v)
    att = tlora.attach(tp, _both_adapter(ads[0])[1], cfgs[0][1])
    assert att["stages"]["0"]["blocks"]["attn"]["qkv"]["lora_s"].shape == (3, 2)


def test_lora_config_carries_dropout():
    """The defaults are the JAX package's: rate 0.1, PEFT's mask placement."""
    j, t = jlora.LoRAConfig(), tlora.LoRAConfig()
    assert (t.dropout, t.dropout_mode) == (j.dropout, j.dropout_mode) == (0.1, "input")
    assert tlora.LoRAConfig(dropout=0.0, dropout_mode="post_a").dropout_mode == "post_a"


@pytest.mark.parametrize("mode", ["input", "post_a"])
def test_lora_dropout_keep_rate_and_unbiased(mode):
    """The adapter branch alone is dropped: keep rate 1 - p (within 4 sigma
    of a binomial), inverted scale, and the mean over many masks is the eval
    form's output, which is the identity on the branch (within 8% of the
    branch's largest value: 2000 masks, and with rank 4 and p = 0.25 one
    mask moves an element by at most 0.58 of it, so 8% is 6 sigma)."""
    rng = _rng(7)
    d, r, o = 32, 4, 6
    p = {"w": rng.standard_normal((d, o)).astype(np.float32) * 0.2,
         "b": rng.standard_normal(o).astype(np.float32),
         "lora_a": rng.standard_normal((d, r)).astype(np.float32) * 0.3,
         "lora_b": rng.standard_normal((r, o)).astype(np.float32) * 0.3,
         "lora_s": np.float32(2.0)}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = torch.from_numpy(rng.standard_normal((50, d)).astype(np.float32))
    drop = tnn.LoRADropout(0.25, mode, torch.Generator().manual_seed(0))
    scale = drop.scale((200, 500), "cpu")
    kept = float((scale > 0).float().mean())
    assert abs(kept - 0.75) < 4 * (0.75 * 0.25 / 1e5) ** 0.5
    assert scale.unique().tolist() == pytest.approx([0.0, 1.0 / 0.75])
    eval_out = tnn.dense(tp, x)
    base_out = tnn.dense({"w": tp["w"], "b": tp["b"]}, x)
    outs = torch.stack([tnn.dense({**tp, "lora_drop": drop}, x) for _ in range(2000)])
    assert not torch.equal(outs[0], outs[1])  # a fresh mask per call
    branch = (eval_out - base_out).abs().max()
    assert float((outs.mean(0) - eval_out).abs().max()) < 0.08 * float(branch)
    # the frozen path sees the undropped input: with B = 0 dropout changes nothing
    zero_b = {**tp, "lora_b": torch.zeros_like(tp["lora_b"]), "lora_drop": drop}
    _close(tnn.dense(zero_b, x), base_out.numpy())


def test_lora_attach_training_form_streams():
    """One seed per target and per stacked layer, all distinct; the eval form
    carries none; ``detach`` strips them; a ViT built from the training form
    drops only in training mode, and equals the JAX eval form otherwise."""
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit as tvit

    rng = _rng(8)
    params = _stacked_params(rng, depth=3)
    targets = tuple(f"blocks/attn/{t}" for t in "qkvo")
    _, tp = _both(params)
    ad = _both_adapter(_adapter(rng, params, targets, rank=2))[1]
    cfg = tlora.LoRAConfig(rank=2, targets=targets, dropout=0.2, dropout_mode="post_a")
    train = tlora.attach(tp, ad, cfg, dropout_seed=5)
    seeds = torch.cat([train["blocks"]["attn"][t]["lora_rng_pa"] for t in "qkvo"])
    assert seeds.shape == (12,) and len(set(seeds.tolist())) == 12
    assert float(train["blocks"]["attn"]["q"]["lora_p"][0]) == pytest.approx(0.2)
    other = tlora.attach(tp, ad, cfg, dropout_seed=6)
    assert not set(seeds.tolist()) & set(other["blocks"]["attn"]["q"]["lora_rng_pa"].tolist())
    evalf = tlora.attach(tp, ad, cfg)
    assert "lora_rng_pa" not in evalf["blocks"]["attn"]["q"]
    no_drop = tlora.attach(tp, ad, tlora.LoRAConfig(rank=2, targets=targets, dropout=0.0),
                           dropout_seed=5)
    assert "lora_rng" not in no_drop["blocks"]["attn"]["q"]
    assert set(ttrees.flatten_with_paths(tlora.detach(train))) == set(ttrees.flatten_with_paths(tp))

    vcfg = tvit.VIT_TEST
    base = tvit.init(vcfg, torch.Generator().manual_seed(0))
    lcfg = tlora.LoRAConfig(rank=2, targets=tvit.LORA_TARGETS_DEFAULT, dropout=0.5)
    vad = tlora.init(torch.Generator().manual_seed(1), base, lcfg)
    for fac in vad.values():
        fac["b"] = torch.randn(fac["b"].shape, generator=torch.Generator().manual_seed(2)) * 0.1
    model = tvit.params_from_jax(tlora.attach(base, vad, lcfg, dropout_seed=0), vcfg)
    plain = tvit.params_from_jax(tlora.attach(base, vad, lcfg), vcfg)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        model.eval()
        assert torch.equal(model(x), plain(x))
        model.train()
        a, b = model(x), model(x)
        assert not torch.equal(a, plain(x)) and not torch.equal(a, b)
    assert set(tvit.params_to_jax(model)) == set(tvit.params_to_jax(plain))


def test_tree_helpers_equal_jax():
    """iter_paths, match_paths, tree_size_bytes, tree_count_params and
    cast_tree against the JAX package's, over tensors and numpy arrays."""
    tree = _stacked_params(_rng(9))
    tree["step"] = np.arange(3, dtype=np.int32)
    jt, tt = _both(tree)
    assert list(ttrees.iter_paths(tt)) == list(jtrees.iter_paths(jt))
    for suffixes in (("q",), ("fc1", "head"), ("attn",), ("nope",)):
        assert ttrees.match_paths(tt, suffixes) == jtrees.match_paths(jt, suffixes)
    for t in (tt, tree):  # tensors, numpy arrays
        assert ttrees.tree_size_bytes(t) == jtrees.tree_size_bytes(jt)
        assert ttrees.tree_count_params(t) == jtrees.tree_count_params(jt)
    cast_t = ttrees.flatten_with_paths(ttrees.cast_tree(tt, torch.bfloat16))
    cast_j = jtrees.flatten_with_paths(jtrees.cast_tree(jt, jnp.bfloat16))
    for p, leaf in cast_t.items():
        assert str(leaf.dtype).split(".")[-1] == str(cast_j[p].dtype), p
        np.testing.assert_array_equal(leaf.float().numpy(), np.asarray(cast_j[p], np.float32))
    assert cast_t["step"].dtype == torch.int32  # integer leaves untouched
    cast_np = ttrees.flatten_with_paths(ttrees.cast_tree(tree, np.float16))
    assert cast_np["head/w"].dtype == np.float16 and cast_np["step"].dtype == np.int32


def test_lora_num_params_equals_jax():
    tree = _stacked_params(_rng(10))
    jt, tt = _both(tree)
    targets = ("blocks/attn/q", "blocks/mlp/fc1")
    jad = jlora.init(jax.random.key(0), jt, jlora.LoRAConfig(rank=3, targets=targets))
    tad = tlora.init(torch.Generator().manual_seed(0), tt, tlora.LoRAConfig(rank=3, targets=targets))
    assert tlora.num_params(tad) == jlora.num_params(jad) == 2 * (8 * 3 + 3 * 8 + 8 * 3 + 3 * 12)
