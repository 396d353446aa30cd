"""The port's weight import (``models/hf_import.py``, ``models/pretrained.py``)
against the JAX package's.

* Every importer's tree equals the JAX importer's on the same state dict,
  bit for bit (atol 0), and so do the two exporters' state dicts.
* HF models built by ``transformers`` from small configs with random
  weights (no download): the imported port model's logits (or, for the
  head-less DINO-style ``ViTModel``, its features) against HF's at the JAX
  tests' tolerances.
* timm naming on state dicts built from a tree (timm is not installed),
  ultralytics naming by round trip, the head re-init on a class-count
  mismatch and the scale guard.
* ``load_checkpoint_state_dict`` on a directory, ``.safetensors`` (written
  with the ``safetensors`` package, bf16 entries included), ``.pth`` and
  ``.bin``; the ``load_pretrained`` facade.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import hf_import as thf
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import pretrained as tpre
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import registry as treg
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import convnext as tcnx
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import swin as tswin
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit as tvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import yolo11 as tyolo
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import trees as ttrees
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import convnext as jcnx
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import hf_import as jhf
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import swin as jswin
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import vit as jvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import yolo11 as jyolo
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import trees as jtrees

transformers = pytest.importorskip("transformers")

VIT_KW = dict(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=128)
# the HF models' geometries, as JAX configs (the port's: _port_cfg)
J_VIT = jvit.ViTConfig(image_size=32, patch_size=8, hidden_dim=64, depth=2, num_heads=2,
                       mlp_dim=128, num_classes=5, compute_dtype="float32")
J_SWIN = jswin.SwinConfig(image_size=32, patch_size=4, window=4, embed_dim=32, depths=(2, 2),
                          num_heads=(2, 4), num_classes=5, compute_dtype="float32")
J_CNX = jcnx.ConvNeXtConfig(image_size=32, depths=(2, 2), dims=(16, 32), num_classes=5,
                            compute_dtype="float32")


def _port_cfg(jc):
    """The port's config with the JAX config's fields."""
    mod = {"ViTConfig": tvit, "SwinConfig": tswin, "ConvNeXtConfig": tcnx,
           "YOLO11Config": tyolo}[type(jc).__name__]
    cls = getattr(mod, type(jc).__name__)
    return cls(**{k: getattr(jc, k) for k in cls.__dataclass_fields__ if hasattr(jc, k)})


VIT_CFG = _port_cfg(J_VIT)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: under pytest-xdist the
    workers share the cores, and a pool of one thread per core makes each
    small eager op wait on the other workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _tnp(tree):
    """A port tree as flat numpy."""
    return {p: v.numpy() for p, v in ttrees.flatten_with_paths(tree).items()}


def _same(got, want):
    """Two trees equal bit for bit: the same paths, f32, the same values."""
    g, w = ttrees.flatten_with_paths(got), jtrees.flatten_with_paths(want)
    assert set(g) == set(w), sorted(set(g) ^ set(w))[:4]
    for p in w:
        assert g[p].dtype == torch.float32, p
        np.testing.assert_array_equal(g[p].numpy(), np.asarray(w[p]), err_msg=p)


def _images(n=2, size=32):
    return np.random.default_rng(0).random((n, size, size, 3), np.float32)


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


@pytest.fixture(scope="module")
def hf():
    """HF models from small configs, random weights from a seed."""
    torch.manual_seed(0)
    return {
        "vit": transformers.ViTForImageClassification(
            transformers.ViTConfig(**VIT_KW, num_labels=5)).eval(),
        "dino": transformers.ViTModel(transformers.ViTConfig(**VIT_KW),
                                      add_pooling_layer=False).eval(),
        "swin": transformers.SwinForImageClassification(transformers.SwinConfig(
            image_size=32, patch_size=4, embed_dim=32, depths=[2, 2], num_heads=[2, 4],
            window_size=4, num_labels=5)).eval(),
        "convnext": transformers.ConvNextForImageClassification(transformers.ConvNextConfig(
            image_size=32, num_stages=2, depths=[2, 2], hidden_sizes=[16, 32],
            num_labels=5)).eval(),
    }


# --- timm-named state dicts, built from a JAX-layout tree (numpy) --------------

def _np_flat(tree):
    return {p: np.asarray(v) for p, v in jtrees.flatten_with_paths(tree).items()}


def _timm_vit_sd(params, cfg):
    f, p, d = _np_flat(params), cfg.patch_size, cfg.hidden_dim
    sd = {"patch_embed.proj.weight": f["embed/proj/w"].reshape(p, p, 3, d).transpose(3, 2, 0, 1),
          "patch_embed.proj.bias": f["embed/proj/b"], "cls_token": f["embed/cls"],
          "pos_embed": f["embed/pos"], "norm.weight": f["final_ln/scale"],
          "norm.bias": f["final_ln/bias"], "head.weight": f["head/w"].T, "head.bias": f["head/b"]}
    for i in range(cfg.depth):
        b = {k[len("blocks/"):]: v[i] for k, v in f.items() if k.startswith("blocks/")}
        pre = f"blocks.{i}"
        sd[f"{pre}.attn.qkv.weight"] = np.concatenate([b[f"attn/{t}/w"].T for t in "qkv"])
        sd[f"{pre}.attn.qkv.bias"] = np.concatenate([b[f"attn/{t}/b"] for t in "qkv"])
        for ours, theirs in (("ln1/scale", "norm1.weight"), ("ln1/bias", "norm1.bias"),
                             ("attn/o/w", "attn.proj.weight"), ("attn/o/b", "attn.proj.bias"),
                             ("ln2/scale", "norm2.weight"), ("ln2/bias", "norm2.bias"),
                             ("mlp/fc1/w", "mlp.fc1.weight"), ("mlp/fc1/b", "mlp.fc1.bias"),
                             ("mlp/fc2/w", "mlp.fc2.weight"), ("mlp/fc2/b", "mlp.fc2.bias")):
            sd[f"{pre}.{theirs}"] = b[ours].T if ours.endswith("/w") else b[ours]
    return sd


def _timm_swin_sd(params, cfg):
    f, p, d = _np_flat(params), cfg.patch_size, cfg.embed_dim
    sd = {"patch_embed.proj.weight": f["embed/proj/w"].reshape(p, p, 3, d).transpose(3, 2, 0, 1),
          "patch_embed.proj.bias": f["embed/proj/b"],
          "patch_embed.norm.weight": f["embed/norm/scale"],
          "patch_embed.norm.bias": f["embed/norm/bias"], "norm.weight": f["final_ln/scale"],
          "norm.bias": f["final_ln/bias"], "head.fc.weight": f["head/w"].T,
          "head.fc.bias": f["head/b"]}
    for s, depth in enumerate(cfg.depths):
        pre_s = f"stages/{s}/blocks/"
        for j in range(depth):
            b = {k[len(pre_s):]: v[j // 2, j % 2] for k, v in f.items() if k.startswith(pre_s)}
            pre = f"layers.{s}.blocks.{j}"
            for ours, theirs in (("ln1/scale", "norm1.weight"), ("ln1/bias", "norm1.bias"),
                                 ("attn/qkv/w", "attn.qkv.weight"), ("attn/qkv/b", "attn.qkv.bias"),
                                 ("attn/proj/w", "attn.proj.weight"),
                                 ("attn/proj/b", "attn.proj.bias"),
                                 ("attn/bias_table", "attn.relative_position_bias_table"),
                                 ("ln2/scale", "norm2.weight"), ("ln2/bias", "norm2.bias"),
                                 ("mlp/fc1/w", "mlp.fc1.weight"), ("mlp/fc1/b", "mlp.fc1.bias"),
                                 ("mlp/fc2/w", "mlp.fc2.weight"), ("mlp/fc2/b", "mlp.fc2.bias")):
                sd[f"{pre}.{theirs}"] = b[ours].T if ours.endswith("/w") else b[ours]
        if s < len(cfg.depths) - 1:
            sd[f"layers.{s}.downsample.norm.weight"] = f[f"stages/{s}/merge/norm/scale"]
            sd[f"layers.{s}.downsample.norm.bias"] = f[f"stages/{s}/merge/norm/bias"]
            sd[f"layers.{s}.downsample.reduction.weight"] = f[f"stages/{s}/merge/reduce/w"].T
    return sd


def _timm_convnext_sd(params, cfg):
    f = _np_flat(params)
    oihw = lambda w: w.transpose(3, 2, 0, 1)  # noqa: E731
    sd = {"stem.0.weight": oihw(f["stem/conv/w"]), "stem.0.bias": f["stem/conv/b"],
          "stem.1.weight": f["stem/norm/scale"], "stem.1.bias": f["stem/norm/bias"],
          "head.norm.weight": f["final_ln/scale"], "head.norm.bias": f["final_ln/bias"],
          "head.fc.weight": f["head/w"].T, "head.fc.bias": f["head/b"]}
    for s, depth in enumerate(cfg.depths):
        pre_s = f"stages/{s}/blocks/"
        for j in range(depth):
            b = {k[len(pre_s):]: v[j] for k, v in f.items() if k.startswith(pre_s)}
            pre = f"stages.{s}.blocks.{j}"
            sd.update({f"{pre}.conv_dw.weight": oihw(b["dwconv/w"]),
                       f"{pre}.conv_dw.bias": b["dwconv/b"], f"{pre}.norm.weight": b["norm/scale"],
                       f"{pre}.norm.bias": b["norm/bias"], f"{pre}.mlp.fc1.weight": b["pwconv1/w"].T,
                       f"{pre}.mlp.fc1.bias": b["pwconv1/b"],
                       f"{pre}.mlp.fc2.weight": b["pwconv2/w"].T,
                       f"{pre}.mlp.fc2.bias": b["pwconv2/b"], f"{pre}.gamma": b["gamma"]})
        if s > 0:
            ds = f"stages/{s}/downsample/"
            sd.update({f"stages.{s}.downsample.0.weight": f[ds + "norm/scale"],
                       f"stages.{s}.downsample.0.bias": f[ds + "norm/bias"],
                       f"stages.{s}.downsample.1.weight": oihw(f[ds + "conv/w"]),
                       f"stages.{s}.downsample.1.bias": f[ds + "conv/b"]})
    return sd


def _jax_init(name, cfg):
    jmod = {"vit": jvit, "swin": jswin, "convnext": jcnx, "yolo11": jyolo}[name]
    return jmod.init(jax.random.key(1), cfg)


def _state_dict(kind, hf):
    """(state dict, importer name, JAX config, keywords) of one importer's case."""
    if kind == "vit_hf":
        return hf["vit"].state_dict(), "vit_params_from_hf", J_VIT, {}
    if kind == "dino_hf":
        return (hf["dino"].state_dict(), "vit_params_from_hf", J_VIT,
                {"prefix": "", "allow_missing_head": True})
    if kind == "swin_hf":
        return hf["swin"].state_dict(), "swin_params_from_hf", J_SWIN, {}
    if kind == "convnext_hf":
        return hf["convnext"].state_dict(), "convnext_params_from_hf", J_CNX, {}
    if kind == "yolo11_ultralytics":
        jc = jyolo.YOLO11_TEST
        return (jhf.ultralytics_from_yolo11_params(_jax_init("yolo11", jc), jc),
                "yolo11_params_from_ultralytics", jc, {})
    family = kind[:-len("_timm")]
    jc = {"vit": jvit.VIT_TEST.with_classes(5), "swin": jswin.SWIN_TEST,
          "convnext": jcnx.CONVNEXT_TEST}[family]
    build = {"vit": _timm_vit_sd, "swin": _timm_swin_sd, "convnext": _timm_convnext_sd}[family]
    return build(_jax_init(family, jc), jc), f"{family}_params_from_timm", jc, {}


@pytest.mark.parametrize("kind", ["vit_hf", "dino_hf", "swin_hf", "convnext_hf", "vit_timm",
                                  "swin_timm", "convnext_timm", "yolo11_ultralytics"])
def test_importer_tree_equals_jax_bit_for_bit(kind, hf):
    sd, name, jc, kw = _state_dict(kind, hf)
    _same(getattr(thf, name)(sd, _port_cfg(jc), **kw), getattr(jhf, name)(sd, jc, **kw))


def test_exporters_equal_jax_bit_for_bit():
    jc = jvit.VIT_TEST.with_classes(5)
    params = _jax_init("vit", jc)
    got = thf.hf_from_vit_params(_np_flat(params), _port_cfg(jc))  # a flat tree is taken too
    want = jhf.hf_from_vit_params(params, jc)
    assert set(got) == set(want)
    for k in want:
        assert got[k].is_contiguous(), k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    yc = jyolo.YOLO11_TEST
    yp = _jax_init("yolo11", yc)
    got = thf.ultralytics_from_yolo11_params(yp, _port_cfg(yc))
    want = jhf.ultralytics_from_yolo11_params(yp, yc)
    assert set(got) == set(want) and "model.9.m.0.attn.qkv.conv.weight" in got
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("family", ["vit", "swin", "convnext"])
def test_imported_logits_match_transformers(family, hf):
    """The JAX tests' tolerances: ViT 5e-4 / 1e-3, Swin atol 2e-6 (a wrong
    shifted-window mask once hid at 2e-5), ConvNeXt 5e-4 / 1e-3."""
    jc, mod = {"vit": (J_VIT, tvit), "swin": (J_SWIN, tswin), "convnext": (J_CNX, tcnx)}[family]
    cfg, importer = _port_cfg(jc), getattr(thf, f"{family}_params_from_hf")
    model = hf[family]
    x = _images()
    with torch.no_grad():
        ref = model(_nchw(x)).logits.numpy()
        ours = mod.apply(cfg, mod.params_from_jax(importer(model.state_dict(), cfg), cfg),
                         torch.from_numpy(x)).numpy()
    if family == "swin":
        np.testing.assert_allclose(ours, ref, atol=2e-6)
    else:
        np.testing.assert_allclose(ours, ref, atol=5e-4, rtol=1e-3)


def test_dino_style_headless_import(hf):
    """A bare ViTModel (prefix '', no classifier): features match HF's last
    hidden state, and the zero head gives zero logits."""
    tree = thf.vit_params_from_hf(hf["dino"].state_dict(), VIT_CFG, prefix="",
                                  allow_missing_head=True)
    model = tvit.params_from_jax(tree, VIT_CFG)
    x = _images()
    with torch.no_grad():
        ref = hf["dino"](_nchw(x)).last_hidden_state.numpy()
        feats = tvit.features(VIT_CFG, model, torch.from_numpy(x)).numpy()
        logits = tvit.apply(VIT_CFG, model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(feats, ref, atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(logits, np.zeros((2, 5), np.float32))
    with pytest.raises(KeyError, match="classifier.weight"):
        thf.vit_params_from_hf(hf["dino"].state_dict(), VIT_CFG, prefix="")


def test_vit_hf_geometry_and_class_count_are_checked(hf):
    sd = hf["vit"].state_dict()
    with pytest.raises(ValueError, match="classes"):
        thf.vit_params_from_hf(sd, VIT_CFG.with_classes(7))
    with pytest.raises(ValueError, match="geometry"):
        thf.vit_params_from_hf(sd, dataclasses.replace(VIT_CFG, patch_size=4))
    # the round trip through the exporter gives the same tree
    tree = thf.vit_params_from_hf(sd, VIT_CFG)
    _same(thf.vit_params_from_hf(thf.hf_from_vit_params(tree, VIT_CFG), VIT_CFG), _tnp(tree))


@pytest.mark.parametrize("family", ["vit", "swin", "convnext"])
def test_timm_maps_round_trip(family):
    """A timm-named state dict built from a tree imports back to that tree,
    and the port model's logits on it are the source tree's."""
    jc = {"vit": jvit.VIT_TEST.with_classes(5), "swin": jswin.SWIN_TEST,
          "convnext": jcnx.CONVNEXT_TEST}[family]
    params = _jax_init(family, jc)
    build = {"vit": _timm_vit_sd, "swin": _timm_swin_sd, "convnext": _timm_convnext_sd}[family]
    sd = {k: torch.from_numpy(np.array(v)) for k, v in build(params, jc).items()}
    tc = _port_cfg(jc)
    tree = getattr(thf, f"{family}_params_from_timm")(sd, tc)
    _same(tree, params)
    entry = treg.get_model(f"{family}_test")
    x = torch.from_numpy(_images(size=tc.image_size))
    with torch.no_grad():
        np.testing.assert_array_equal(
            entry.apply(tc, entry.from_tree(tree, tc), x).numpy(),
            entry.apply(tc, entry.from_tree(_np_flat(params), tc), x).numpy())


def test_ultralytics_round_trip_head_reinit_and_scale_guard(tmp_path):
    cfg = tyolo.YOLO11_TEST
    tree = tyolo.init(cfg, torch.Generator().manual_seed(0))
    sd = thf.ultralytics_from_yolo11_params(tree, cfg)
    assert all(k.startswith("model.") for k in sd) and "model.10.linear.weight" in sd
    _same(thf.yolo11_params_from_ultralytics(sd, cfg), _tnp(tree))
    # the whole wrapper pickled: one more "model." level
    _same(thf.yolo11_params_from_ultralytics({f"model.{k}": v for k, v in sd.items()}, cfg),
          _tnp(tree))
    # another class count: the head's linear zeroed, everything else kept
    with pytest.raises(KeyError, match="10-class"):
        thf.yolo11_params_from_ultralytics(sd, cfg.with_classes(7))
    re = ttrees.flatten_with_paths(
        thf.yolo11_params_from_ultralytics(sd, cfg.with_classes(7), allow_missing_head=True))
    src = ttrees.flatten_with_paths(tree)
    for p, v in re.items():
        if p.startswith("head/linear/"):
            assert v.shape[-1] == 7 and not v.any(), p
        else:
            assert torch.equal(v, src[p]), p
    model = tyolo.params_from_jax(re, cfg.with_classes(7))
    with torch.no_grad():
        assert not model(torch.rand(1, 64, 64, 3)).any()
    # the scale guard: s-scale weights into an n-scale config
    s_cfg = tyolo.YOLO11Config(image_size=64, scale="s", num_classes=10, head_width=128,
                               compute_dtype="float32")
    s_sd = thf.ultralytics_from_yolo11_params(tyolo.init(s_cfg), s_cfg)
    with pytest.raises(ValueError, match="wrong model scale"):
        thf.yolo11_params_from_ultralytics(s_sd, cfg)
    with pytest.raises(KeyError, match="param-tree mismatch"):  # a second C2PSA block
        thf.yolo11_params_from_ultralytics(
            {**sd, **{k.replace(".9.m.0.", ".9.m.1."): v for k, v in sd.items()
                      if ".9.m.0." in k}}, cfg)
    with pytest.raises(KeyError, match="cv3"):
        thf.yolo11_params_from_ultralytics(
            {k: v for k, v in sd.items() if ".cv3." not in k}, cfg)
    with pytest.raises(ValueError, match="unrecognized ultralytics"):
        thf.yolo11_params_from_ultralytics({"backbone.0.weight": torch.zeros(1)}, cfg)


@pytest.mark.parametrize("form", ["directory_safetensors", "safetensors", "pth", "bin",
                                  "directory_bin"])
def test_load_checkpoint_state_dict_forms(form, tmp_path):
    """Every form reads back as f32 CPU tensors with the values written
    (bf16 entries widened exactly), as the JAX reader reads them."""
    from safetensors.torch import save_file

    rng = np.random.default_rng(0)
    sd = {"a.weight": torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)),
          "b.bias": torch.from_numpy(rng.standard_normal(5).astype(np.float32)).bfloat16(),
          "c.count": torch.arange(3)}
    d = tmp_path / "m"
    d.mkdir()
    if form in ("directory_safetensors", "safetensors"):
        path = str(d / "model.safetensors")
        save_file(sd, path)
    else:
        path = str(d / ("pytorch_model.bin" if form != "pth" else "weights.pth"))
        torch.save(sd, path)
    got = thf.load_checkpoint_state_dict(str(d) if form.startswith("directory") else path)
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        assert torch.equal(got[k], v.float()), k
    if form == "pth":
        want = jhf.load_checkpoint_state_dict(path)
        assert all(np.array_equal(got[k].numpy(), want[k]) for k in sd)
    with pytest.raises(FileNotFoundError, match="no weights file"):
        thf.load_checkpoint_state_dict(str(tmp_path))


def test_load_pretrained_facade(tmp_path, hf):
    # random init from a seed, on the device asked for
    entry, cfg, tree = tpre.load_pretrained("swin_test", 4, None,
                                            generator=torch.Generator().manual_seed(1))
    assert cfg.num_classes == 4 and entry.family == "swin"
    _same(tree, _tnp(tswin.init(cfg, torch.Generator().manual_seed(1))))
    # HF ViT .pth: ViTForImageClassification naming
    p = str(tmp_path / "ckpt.pth")
    torch.save(hf["vit"].state_dict(), p)
    entry, cfg, tree = tpre.load_pretrained("vit_test", 5, p, device="cpu")
    _same(tree, thf.vit_params_from_hf(hf["vit"].state_dict(), cfg))
    x = torch.zeros(1, 32, 32, 3)
    assert entry.apply(cfg, entry.from_tree(tree, cfg), x).shape == (1, 5)
    # a head-less DINO state dict: prefix "" and a zero head
    p_dino = str(tmp_path / "dino.bin")
    torch.save(hf["dino"].state_dict(), p_dino)
    _, _, tree_d = tpre.load_pretrained("vit_test", 3, p_dino)
    assert not tree_d["head"]["w"].any() and tree_d["head"]["w"].shape == (64, 3)
    # timm naming is detected
    jc = jvit.VIT_TEST.with_classes(5)
    p_timm = str(tmp_path / "timm.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in _timm_vit_sd(_jax_init("vit", jc), jc).items()}, p_timm)
    _same(tpre.load_pretrained("vit_test", 5, p_timm)[2], _jax_init("vit", jc))
    # ultralytics: an HF state dict is not one; another class count re-inits the head
    with pytest.raises(ValueError):
        tpre.load_pretrained("yolo11_test", 4, p)
    yc = tyolo.YOLO11_TEST
    p_y = str(tmp_path / "yolo11n-cls.pth")
    torch.save(thf.ultralytics_from_yolo11_params(tyolo.init(yc), yc), p_y)
    _, cfg_y, tree_y = tpre.load_pretrained("yolo11_test", 4, p_y)
    assert cfg_y.num_classes == 4 and not tree_y["head"]["linear"]["w"].any()
    _, _, tree_same = tpre.load_pretrained("yolo11_test", 10, p_y)
    _same(tree_same, _tnp(tyolo.init(yc)))
    with pytest.raises(FileNotFoundError):
        tpre.load_pretrained("vit_test", 5, str(tmp_path / "missing.pth"))
