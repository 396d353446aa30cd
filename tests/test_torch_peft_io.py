"""The port's PEFT adapter reader/writer against the JAX package's.

Adapters written by either package load in the other with identical values
(f32 factors and heads cross unchanged, so the comparison is exact): ViT
targets under HF-PEFT keys, Swin targets under ``framework.`` keys, linear
heads as PEFT's classifier, other head trees under ``framework_head.``. A
ViT directory written by the port loads in HF PEFT, whose merge must equal
W + s*(A B) within f32 rounding (atol 1e-6).
"""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import lora as tlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import peft_io as tpeft
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import lora as jlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import peft_io as jpeft

VIT_TARGETS = ("blocks/attn/q", "blocks/attn/v", "blocks/attn/o", "blocks/mlp/fc2")
SWIN_TARGETS = ("stages/0/blocks/attn/qkv", "stages/1/blocks/attn/proj")


def _factors(targets, shapes, rank=4, seed=0):
    rng = np.random.default_rng(seed)
    return {p: {"a": rng.standard_normal((*lead, di, rank)).astype(np.float32),
                "b": rng.standard_normal((*lead, rank, do)).astype(np.float32)}
            for p, (lead, di, do) in zip(targets, shapes)}


def _vit_adapter(seed=0):
    return _factors(VIT_TARGETS, [((2,), 64, 64)] * 3 + [((2,), 128, 64)], seed=seed)


def _swin_adapter(seed=1):
    return _factors(SWIN_TARGETS, [((1, 2), 32, 96), ((1, 2), 64, 64)], seed=seed)


def _head(seed=2, d=64, c=5):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((d, c)).astype(np.float32),
            "b": rng.standard_normal(c).astype(np.float32)}


def _nested_head(seed=3):
    rng = np.random.default_rng(seed)
    return {"conv": {"w": rng.standard_normal((1, 1, 3, 4)).astype(np.float32)},
            "linear": {"w": rng.standard_normal((4, 5)).astype(np.float32),
                       "b": rng.standard_normal(5).astype(np.float32)}}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_same(got[k], want[k])
        else:
            g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
            np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)


CASES = {"vit": (_vit_adapter, _head), "swin": (_swin_adapter, _head),
         "nested_head": (_swin_adapter, _nested_head), "no_head": (_vit_adapter, None)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_written_adapter_loads_in_port(case, tmp_path):
    make_ad, make_head = CASES[case]
    ad, head = make_ad(), make_head() if make_head else None
    cfg = jlora.LoRAConfig(rank=4, alpha=16.0, targets=tuple(ad), dropout=0.05)
    jpeft.save_peft_adapter({p: {k: jnp.asarray(v) for k, v in f.items()} for p, f in ad.items()},
                            cfg, str(tmp_path), head=head)
    got, got_cfg, got_head = tpeft.load_peft_adapter(str(tmp_path))
    _assert_same(got, ad)
    assert (got_cfg.rank, got_cfg.alpha, got_cfg.dropout) == (4, 16.0, 0.05)
    assert got_cfg.targets == tuple(sorted(ad))
    if head is None:
        assert got_head is None
    else:
        _assert_same(got_head, head)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_written_adapter_loads_in_jax(case, tmp_path):
    make_ad, make_head = CASES[case]
    ad, head = make_ad(), make_head() if make_head else None
    cfg = tlora.LoRAConfig(rank=4, alpha=16.0, targets=tuple(ad), dropout=0.05)
    tpeft.save_peft_adapter(_to_torch(ad), cfg, str(tmp_path),
                            head=_to_torch(head) if head else None)
    got, got_cfg, got_head = jpeft.load_peft_adapter(str(tmp_path))
    _assert_same(got, ad)
    assert (got_cfg.rank, got_cfg.alpha, got_cfg.dropout) == (4, 16.0, 0.05)
    if head is None:
        assert got_head is None
    else:
        _assert_same(got_head, head)
    # the same files the JAX package writes, key for key and config for config
    jdir = str(tmp_path / "jax")
    jpeft.save_peft_adapter({p: {k: jnp.asarray(v) for k, v in f.items()} for p, f in ad.items()},
                            jlora.LoRAConfig(rank=4, alpha=16.0, targets=tuple(ad), dropout=0.05),
                            jdir, head=head)
    import json

    with open(tmp_path / "adapter_config.json") as f, open(os.path.join(jdir, "adapter_config.json")) as g:
        assert json.load(f) == json.load(g)


def test_framework_head_keeps_bf16_byte_exact(tmp_path):
    head = {"conv": {"w": torch.randn(1, 1, 3, 4).to(torch.bfloat16)},
            "linear": {"w": torch.randn(4, 5).to(torch.bfloat16), "b": torch.randn(5)}}
    ad = _to_torch(_swin_adapter())
    tpeft.save_peft_adapter(ad, tlora.LoRAConfig(rank=4, targets=tuple(ad)), str(tmp_path),
                            head=head)
    _, _, got = tpeft.load_peft_adapter(str(tmp_path))
    for path in (("conv", "w"), ("linear", "w"), ("linear", "b")):
        g, w = got[path[0]][path[1]], head[path[0]][path[1]]
        assert g.dtype == w.dtype
        assert torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16 else g,
                           w.view(torch.int16) if w.dtype == torch.bfloat16 else w)


def test_adapter_model_bin_is_read(tmp_path):
    ad = _vit_adapter()
    out = str(tmp_path / "st")
    tpeft.save_peft_adapter(_to_torch(ad), tlora.LoRAConfig(rank=4, targets=tuple(ad)), out)
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import checkpoint

    tensors, _ = checkpoint.load_tensors(os.path.join(out, "adapter_model.safetensors"))
    os.remove(os.path.join(out, "adapter_model.safetensors"))
    torch.save(tensors, os.path.join(out, "adapter_model.bin"))
    got, _, _ = tpeft.load_peft_adapter(out)
    _assert_same(got, ad)


def test_peft_library_loads_port_vit_adapter(tmp_path):
    """HF PEFT reads the port's ViT directory; its merged weights equal
    W + s*(A B) per layer and its classifier is the saved head."""
    peft = pytest.importorskip("peft")
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.ViTForImageClassification(transformers.ViTConfig(
        image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=128, num_labels=5)).eval()
    ad = _factors(("blocks/attn/q", "blocks/attn/v"), [((2,), 64, 64)] * 2)
    for f in ad.values():
        f["b"] *= 0.01
    head = _head()
    cfg = tlora.LoRAConfig(rank=4, alpha=16.0, targets=tuple(ad))
    tpeft.save_peft_adapter(_to_torch(ad), cfg, str(tmp_path), head=_to_torch(head))
    merged = peft.PeftModel.from_pretrained(copy.deepcopy(hf), str(tmp_path)).merge_and_unload()
    for i in range(2):
        for path, mod in (("blocks/attn/q", "query"), ("blocks/attn/v", "value")):
            base = getattr(hf.vit.encoder.layer[i].attention.attention, mod).weight.detach()
            got = getattr(merged.vit.encoder.layer[i].attention.attention, mod).weight.detach()
            delta = cfg.scale * torch.from_numpy(ad[path]["a"][i] @ ad[path]["b"][i]).T
            torch.testing.assert_close(got, base + delta, atol=1e-6, rtol=0)
    torch.testing.assert_close(merged.classifier.weight.detach(),
                               torch.from_numpy(head["w"]).T, atol=0, rtol=0)


@pytest.mark.parametrize("modules", [["query", "value"], ["query", "key", "value", "output.dense"],
                                     ["intermediate.dense", "output.dense", "query"],
                                     ["query", "query", "unknown"], []])
def test_peft_targets_to_paths_equals_jax(modules):
    assert tpeft.peft_targets_to_paths(modules) == jpeft.peft_targets_to_paths(modules)
    assert tpeft.peft_targets_to_paths(["output.dense"]) == ("blocks/attn/o", "blocks/mlp/fc2")
