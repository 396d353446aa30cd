"""The port's data x model mesh (``parallel/``) on gloo on the CPU.

Placements against the JAX package's ``tree_shardings``; every stage run
sharded (``parallel.compare``, spawned ranks that import the port only)
against the single-process port at the same seed; the sharded train step
and PGD against the JAX package's sharded ones, from the same params. Two
spawns (4 ranks: meshes (2, 2) and (4, 1); 2 ranks: (2, 1) and (1, 2)), one
torch thread per rank.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data import synthetic as tsynth
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import convnext as tcnx
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import swin as tswin
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit as tvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import lora as tlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.parallel import compare, launch
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.parallel import mesh as tmesh
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import checkpoint as tck
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import trees as ttrees
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.attacks import whitebox as jwb
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import vit as jvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.parallel import mesh as jmesh
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.train import steps as jsteps
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import checkpoint as jck
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import trees as jtrees

EPS = 8 / 255
B = 16
FIELDS = ("use_fused_mlp", "fuse_ln_mlp")  # the opt-in ViT kernels that take a rank's slices
ATTACK_STAGES = ["forward", "train_step", "pgd", "apgd", "square", "patch", "rp2", "eval"]


def _flat_np(tree):
    return {p: np.array(v) for p, v in ttrees.flatten_with_paths(tree).items()}


def _torch_tree(flat_np):
    return {p: torch.from_numpy(v.copy()) for p, v in flat_np.items()}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # the ranks take one thread each; so does this process beside them
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def inputs():
    """The batch and the trees, every bias and LayerNorm leaf moved off its
    init value, so that each comparison holds where a split bias goes in."""
    rng = np.random.default_rng(0)
    return {"images": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "labels": (np.arange(B) % 10).astype(np.int64),
            "vit": _flat_np(compare.jitter_affine(
                tvit.init(tvit.VIT_TEST, torch.Generator().manual_seed(0)), 20)),
            "swin": _flat_np(compare.jitter_affine(
                tswin.init(tswin.SWIN_TEST, torch.Generator().manual_seed(1)), 21))}


def _job(inputs, tmp, runs):
    job = {"model": "vit_test", "num_classes": 10, "tree": _torch_tree(inputs["vit"]),
           "images": torch.from_numpy(inputs["images"]),
           "labels": torch.from_numpy(inputs["labels"]), "stages": [],
           "workdir": str(tmp / "work"), "data_root": str(tmp / "data"), "runs": runs}
    return job


def _spawn(job, n, tmp, name):
    job_path, out_path = str(tmp / f"{name}.job"), str(tmp / f"{name}.out")
    torch.save(job, job_path)
    launch.spawn(compare.run_rank, n, device="cpu", args=(job_path, out_path), log=lambda s: None)
    return torch.load(out_path, weights_only=False)


def _cnx_tree():
    return compare.jitter_affine(tcnx.init(tcnx.CONVNEXT_TEST, torch.Generator().manual_seed(2)),
                                 22)


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """``{(model, spec): (sharded outputs, single-process outputs, counts)}``."""
    tmp = tmp_path_factory.mktemp("mesh")
    tsynth.make_synthetic_dataset(str(tmp / "data"), classes=tsynth.HARD_CLASSES[:10],
                                  n_per_class=2, image_size=32, seed=3, style="hard")
    full = ATTACK_STAGES + ["pgd_fixed", "lora_step_post_a", "compose", "checkpoint", "files"]
    four = [{"spec": (2, 2), "stages": full}, {"spec": (4, 1), "stages": ATTACK_STAGES}]
    swin_tree = _torch_tree(inputs["swin"])
    two = [{"spec": (2, 1), "stages": ["lora_step", "forward"]},
           {"spec": (1, 2), "stages": ["forward", "train_step", "lora_step", "lora_step_post_a"]},
           {"spec": (1, 2), "model": "swin_test", "tree": swin_tree,
            "stages": ["forward", "train_step"]},
           {"spec": (1, 2), "model": "convnext_test", "tree": _cnx_tree(),
            "stages": ["forward", "train_step"]},
           *({"spec": (1, 2), "fields": {"compute_dtype": "bfloat16", field: True},
              "stages": ["forward", "train_step"]} for field in FIELDS)]
    out = {}
    for n, plan in ((4, four), (2, two)):
        job = _job(inputs, tmp, plan)
        sharded = _spawn(job, n, tmp, f"n{n}")
        for run, res in zip(plan, sharded):
            single = compare.run_stages({**job, **run}, "cpu")
            key = (run.get("model", "vit_test"), run["spec"])
            field = [f for f in run.get("fields", {}) if f in FIELDS]
            out[key + tuple(field)] = (res["outputs"], single, res["counts"])
    out["tmp"] = tmp
    return out


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


# --- placements -----------------------------------------------------------------

def test_mesh_spec_resolves_as_jax():
    for spec, n in ((tmesh.MeshSpec(), 8), (tmesh.MeshSpec(data=-1, model=2), 8),
                    (tmesh.MeshSpec(data=2, model=2), 4)):
        jspec = jmesh.MeshSpec(data=spec.data, model=spec.model)
        assert spec.resolve(n) == jspec.resolve(n)
    for data, model, n in ((3, 2, 4), (-1, 3, 4)):
        with pytest.raises(ValueError) as want:
            jmesh.MeshSpec(data=data, model=model).resolve(n)
        with pytest.raises(ValueError, match=str(want.value)):
            tmesh.MeshSpec(data=data, model=model).resolve(n)


def _fake_mesh(data, model):
    # tree_shardings reads only the mesh's shape and dim names
    return types.SimpleNamespace(shape=(data, model), mesh_dim_names=("data", "model"))


@pytest.mark.parametrize("which", ["vit_lora", "swin"])
def test_placements_match_jax_tree_shardings(which, eight_devices, inputs):
    """Both packages' rules over the same tree (numpy leaves, the JAX
    layout: ViT with LoRA attached in the JAX package's leaf names)."""
    if which == "vit_lora":
        tree = tvit.init(tvit.VIT_TEST, torch.Generator().manual_seed(0))
        lcfg = tlora.LoRAConfig(rank=4, targets=tvit.LORA_TARGETS_DEFAULT)
        tree = tlora.attach(tree, tlora.init(torch.Generator().manual_seed(1), tree, lcfg), lcfg)
    else:
        tree = tswin.init(tswin.SWIN_TEST, torch.Generator().manual_seed(1))
    params = jtrees.unflatten_from_paths(_flat_np(tree))
    m = jmesh.make_mesh(jmesh.MeshSpec(data=2, model=2), devices=jax.devices()[:4])
    want = {p: tuple(s.spec) for p, s in
            jtrees.flatten_with_paths(jmesh.tree_shardings(m, params)).items()}
    got = tmesh.tree_shardings(_fake_mesh(2, 2), _flat_np(params))
    assert got == want
    assert any(want.values()) == (which == "vit_lora")  # Swin's rank-4 leaves match no rule
    assert not any(tmesh.tree_shardings(_fake_mesh(4, 1), _flat_np(params)).values())
    assert tmesh.batch_sharding(None, 4) == tuple(jmesh.batch_sharding(m, 4).spec)
    assert tmesh.replicated(None) == tuple(jmesh.replicated(m).spec)


def test_shard_batch_rows_and_divisibility():
    x = np.arange(24).reshape(8, 3)
    mesh = types.SimpleNamespace(shape=(4, 1), mesh_dim_names=("data", "model"),
                                 get_local_rank=lambda dim: 2 if dim == 0 else 0)
    rows, scalar = tmesh.shard_batch(mesh, x, np.float32(3.0))
    assert np.array_equal(rows, x[4:6]) and scalar == 3.0
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_batch(mesh, np.zeros((6, 2)))


def test_shard_tree_splits_by_the_rules(inputs):
    mesh = types.SimpleNamespace(shape=(1, 2), mesh_dim_names=("data", "model"),
                                 get_local_rank=lambda dim: dim)
    flat = _torch_tree(inputs["vit"])
    local = tmesh.shard_tree(mesh, flat)
    assert torch.equal(local["blocks/attn/q/w"], flat["blocks/attn/q/w"][:, :, 32:])
    assert torch.equal(local["blocks/attn/o/w"], flat["blocks/attn/o/w"][:, 32:, :])
    assert torch.equal(local["blocks/mlp/fc1/b"], flat["blocks/mlp/fc1/b"][:, 64:])
    assert local["embed/pos"] is flat["embed/pos"]


# --- sharded against single-process -------------------------------------------------

@pytest.mark.parametrize("spec", [(2, 2), (4, 1), (2, 1), (1, 2)])
def test_sharded_forward_matches_single_process(runs, spec):
    got, want, _ = runs[("vit_test", spec)]
    _close(got["forward"]["logits"], want["forward"]["logits"], 1e-5, 1e-6, f"logits {spec}")


@pytest.mark.parametrize("spec", [(2, 2), (4, 1), (1, 2)])
def test_sharded_train_step_matches_single_process(runs, spec):
    got, want, _ = runs[("vit_test", spec)]
    g, w = got["train_step"], want["train_step"]
    _close(g["loss"], w["loss"], 1e-5, 0, "loss")
    for name in w["grads"]:
        _close(g["grads"][name], w["grads"][name], 1e-4, 1e-6, f"grad {name}")
    # Adam's first step divides by sqrt(nu)+eps: near-zero gradients amplify
    # reduction-order noise up to ~lr (tests/test_mesh.py bounds it by 2.5e-3)
    for path in w["params"]:
        _close(g["params"][path], w["params"][path], 0, 2.5e-3, f"param {path}")


@pytest.mark.parametrize("spec", [(2, 2), (1, 2)])
def test_tp_group_gradient_is_not_counted_tp_times(runs, spec):
    """Each rank of a model group computes the same loss: a whole leaf gets
    the same gradient on every rank of the group, and no gradient is summed
    over the group again (which would multiply it by the group's size)."""
    got, want, _ = runs[("vit_test", spec)]
    g, w = got["train_step"], want["train_step"]
    assert float(g["whole_grad_spread"]) == 0.0
    for name in ("blocks.0.attn.q.w", "blocks.0.attn.o.w", "blocks.1.ln1.scale", "head.w"):
        ratio = float(g["grads"][name].norm() / w["grads"][name].norm())
        assert abs(ratio - 1.0) < 1e-4, (name, ratio)


@pytest.mark.parametrize("spec", [(2, 2), (4, 1)])
@pytest.mark.parametrize("stage", ["pgd", "apgd", "square", "patch", "rp2"])
def test_sharded_attacks_match_single_process(runs, spec, stage):
    got, want, _ = runs[("vit_test", spec)]
    g, w = got[stage], want[stage]
    if stage == "rp2":  # one patch per class, trained on shares of each minibatch
        assert list(g) == list(w) == ["0", "1"]
        for c in w:
            _close(g[c], w[c], 0, 5e-3, f"rp2 class {c}")
        return
    if stage == "patch":
        _close(g["losses"], w["losses"], 0, 1e-4, "patch losses")
        _close(g["patch"], w["patch"], 0, 5e-3, "patch")
        return
    if spec[1] == 1:  # data parallel: the JAX package's bound (tests/test_mesh.py)
        _close(g["adv"], w["adv"], 0, 2e-5, f"{stage} adv")
    else:
        # the model axis adds partial sums in another order: a gradient
        # component near zero can change sign, which moves its pixel a step
        ok = np.abs(g["adv"].numpy() - w["adv"].numpy()) <= 2e-5
        assert ok.mean() >= 0.999, f"{stage}: only {ok.mean():.5f} of pixels agree"
    if stage == "apgd":
        _close(g["f"], w["f"], 0, 1e-4, "apgd f")


@pytest.mark.parametrize("spec", [(2, 2), (4, 1)])
def test_sharded_eval_sums_over_the_global_batch(runs, spec):
    got, want, _ = runs[("vit_test", spec)]
    assert torch.equal(got["eval"]["confusion"], want["eval"]["confusion"])
    assert float(got["eval"]["confusion"].sum()) == B
    _close(got["eval"]["loss_sum"], want["eval"]["loss_sum"], 1e-5, 0, "eval loss")


def test_sharded_compose_matrix_matches_single_process(runs):
    got, want, _ = runs[("vit_test", (2, 2))]
    g, w = got["compose"]["results"], want["compose"]["results"]
    assert list(g) == ["base", "lora_ad1", "lora_ad2", "ad1+ad2"] == list(w)
    for variant in w:
        for ds in w[variant]:
            assert g[variant][ds]["accuracy"] == w[variant][ds]["accuracy"]
            assert g[variant][ds]["support"] == w[variant][ds]["support"] == B
            _close(g[variant][ds]["loss"], w[variant][ds]["loss"], 1e-5, 0, "compose loss")
    assert os.path.exists(runs["tmp"] / "work" / "2x2" / "compose.json")


def test_sharded_checkpoint_round_trip_is_bit_exact_and_read_by_jax(runs):
    got, want, _ = runs[("vit_test", (2, 2))]
    assert bool(got["checkpoint"]["bit_equal"]) and bool(want["checkpoint"]["bit_equal"])
    work = runs["tmp"] / "work"
    tree, _ = jck.load_pytree(str(work / "2x2" / "params.safetensors"))
    flat = jtrees.flatten_with_paths(tree)
    assert set(flat) == set(got["checkpoint"]["params"])
    for path, v in got["checkpoint"]["params"].items():
        assert np.array_equal(np.asarray(flat[path]), v.numpy()), path
    # the sharded resume file names and shapes are the single-process one's
    a, _ = tck.load_pytree(str(work / "2x2" / "state.state.safetensors"))
    b, _ = tck.load_pytree(str(work / "single" / "state.state.safetensors"))
    fa, fb = jtrees.flatten_with_paths(a), jtrees.flatten_with_paths(b)
    assert {p: tuple(v.shape) for p, v in fa.items()} == {p: tuple(v.shape) for p, v in fb.items()}
    state, _ = jck.load_pytree(str(work / "2x2" / "state.state.safetensors"))
    assert {p: v.shape for p, v in jtrees.flatten_with_paths(state).items()} == {
        p: tuple(v.shape) for p, v in fa.items()}


def test_sharded_loops_and_generate_write_the_single_process_files(runs):
    """train_base_model (fit, evaluate), train_lora_adapter and
    generate_adversarial_split under (2, 2): the same files, the PNG bytes
    and metadata.csv equal."""
    got, want, _ = runs[("vit_test", (2, 2))]
    work = runs["tmp"] / "work"
    assert float(got["files"]["test_accuracy"]) == float(want["files"]["test_accuracy"])
    for sub in ("base", "lora", "adv"):
        names = sorted(os.listdir(work / "single" / sub))
        assert sorted(os.listdir(work / "2x2" / sub)) == names, sub
    adv_s, adv_m = work / "single" / "adv", work / "2x2" / "adv"
    # the rows name each run's own output directory
    assert ((adv_s / "metadata.csv").read_bytes()
            == (adv_m / "metadata.csv").read_bytes().replace(b"/2x2/", b"/single/"))
    pngs = sorted(os.listdir(adv_s / "images"))
    assert pngs and pngs == sorted(os.listdir(adv_m / "images"))
    for name in pngs:
        assert (adv_s / "images" / name).read_bytes() == (adv_m / "images" / name).read_bytes()
    for name in ("vit_test_best_model_finetuned.safetensors", "vit_test_final_model.safetensors"):
        ts, _ = tck.load_pytree(str(work / "single" / "base" / name))
        tm, _ = tck.load_pytree(str(work / "2x2" / "base" / name))
        fs, fm = jtrees.flatten_with_paths(ts), jtrees.flatten_with_paths(tm)
        assert set(fs) == set(fm)
        for p in fs:
            _close(fm[p], fs[p], 0, 2.5e-3, f"{name} {p}")


def test_lora_step_with_dropout_and_augmentation_is_global_then_slice(runs):
    """Dropout 0.1 and the augmentation on: at (2, 1) every draw is this
    rank's rows of the global draw, so the step is the single-process one;
    at (1, 2) the row-split denses take their columns of the dropout mask."""
    for spec in ((2, 1), (1, 2)):
        got, want, _ = runs[("vit_test", spec)]
        g, w = got["lora_step"], want["lora_step"]
        _close(g["loss"], w["loss"], 1e-5, 0, f"lora loss {spec}")
        for name in w["grads"]:
            _close(g["grads"][name], w["grads"][name], 1e-4, 1e-6, f"grad {name} {spec}")
        for path, fac in w["trained"]["adapter"].items():
            for k in ("a", "b"):
                _close(g["trained"]["adapter"][path][k], fac[k], 0, 2.5e-3, f"{path} {k}")


@pytest.mark.parametrize("spec", [(1, 2), (2, 2)])
def test_lora_step_post_a_dropout_under_a_model_axis_is_the_single_process_step(runs, spec):
    """Dropout on ``x @ lora_a`` (mode ``post_a``): on a row-split dense each
    rank of a model group holds a partial sum of that product, so every rank
    draws the same whole mask and the sum over the group is the masked
    product, as on one process."""
    got, want, _ = runs[("vit_test", spec)]
    g, w = got["lora_step_post_a"], want["lora_step_post_a"]
    _close(g["loss"], w["loss"], 1e-5, 0, f"lora loss {spec}")
    # the adapter's B starts at zero: the mask shows in B's gradient, not in the loss
    assert any("attn.o.lora_b" in n for n in w["grads"])
    for name in w["grads"]:
        _close(g["grads"][name], w["grads"][name], 1e-4, 1e-6, f"grad {name} {spec}")
    for path, fac in w["trained"]["adapter"].items():
        for k in ("a", "b"):
            _close(g["trained"]["adapter"][path][k], fac[k], 0, 2.5e-3, f"{path} {k}")


@pytest.mark.parametrize("field", FIELDS)
def test_opt_in_kernels_under_tp_match_single_process(runs, field):
    """bf16 with each opt-in kernel at (1, 2), through the kernels' plain
    versions (the CPU): the kernels run on each rank's slices, the output
    bias goes in once after the reduce, and the fused input and LayerNorm
    parameters' gradients are summed over the model group (a gradient
    counted once per rank, or partial, is off by a factor near 2)."""
    got, want, _ = runs[("vit_test", (1, 2), field)]
    _close(got["forward"]["logits"], want["forward"]["logits"], 5e-2, 5e-2, "bf16 logits")
    g, w = got["train_step"], want["train_step"]
    _close(g["loss"], w["loss"], 1e-2, 0, "loss")
    assert float(g["whole_grad_spread"]) == 0.0
    for name, want_g in w["grads"].items():
        if name.endswith("attn.k.b"):
            # zero in exact arithmetic (softmax shift invariance): bf16 noise on
            # both sides, bounded by the same block's q bias gradient, not compared
            ref = float(w["grads"][name.replace("k.b", "q.b")].norm())
            assert max(float(g["grads"][name].norm()), float(want_g.norm())) < 0.1 * ref, name
            continue
        rel = float((g["grads"][name].float() - want_g.float()).norm() / want_g.float().norm())
        assert rel < 5e-2, (name, rel)


def test_fuse_attn_block_under_tp_raises(inputs):
    """The half-block kernel takes square weights: under a model axis it
    raises (no quiet library path), on the CPU as on the card."""
    mesh = types.SimpleNamespace(shape=(1, 2), mesh_dim_names=("data", "model"),
                                 get_local_rank=lambda dim: 0, get_group=lambda dim: None)
    cfg = tvit.VIT_TEST.__class__(**{**tvit.VIT_TEST.__dict__, "compute_dtype": "bfloat16",
                                     "fuse_attn_block": True})
    model = tvit.params_from_jax(_torch_tree(inputs["vit"]), cfg, mesh=mesh)
    with pytest.raises(ValueError, match="square"):
        model(torch.zeros(2, 32, 32, 3))


@pytest.mark.parametrize("model", ["swin_test", "convnext_test"])
def test_replicated_backbones_match_single_process_at_1x2(runs, model):
    got, want, _ = runs[(model, (1, 2))]
    _close(got["forward"]["logits"], want["forward"]["logits"], 1e-5, 1e-6, "logits")
    g, w = got["train_step"], want["train_step"]
    _close(g["loss"], w["loss"], 1e-5, 0, "loss")
    assert float(g["whole_grad_spread"]) == 0.0
    for name in w["grads"]:
        _close(g["grads"][name], w["grads"][name], 1e-5, 1e-7, name)


def test_replicated_backbones_hold_every_leaf_whole():
    mesh = _fake_mesh(1, 2)
    for mod, cfg in ((tswin, tswin.SWIN_TEST), (tcnx, tcnx.CONVNEXT_TEST)):
        flat = _torch_tree(_flat_np(mod.init(cfg, torch.Generator().manual_seed(0))))
        assert tmesh.model_dims(mesh, flat) == {}


def test_ranks_import_neither_jax_nor_the_tests(runs):
    """The spawned ranks ran the port only: no rank had jax, the JAX package
    or a test module among its imports (each rank reports them)."""
    for key, value in runs.items():
        if key != "tmp":
            assert all(c["foreign_modules"] == [] for c in value[2]), key


# --- against the JAX package ------------------------------------------------------

def test_sharded_train_step_matches_jax_sharded_step(runs, inputs, eight_devices):
    """The tests/test_mesh.py setup at (2, 2): optax.adam(1e-3), no
    normalization, from the same params."""
    m = jmesh.make_mesh(jmesh.MeshSpec(data=2, model=2), devices=jax.devices()[:4])
    params = jtrees.unflatten_from_paths({p: jnp.asarray(v) for p, v in inputs["vit"].items()})
    tx = optax.adam(1e-3)
    train = jsteps.make_train_step(lambda p, x: jvit.apply(jvit.VIT_TEST, p, x), tx,
                                   normalize=None)
    state = jsteps.TrainState.create(jax.device_put(params, jmesh.tree_shardings(m, params)), tx)
    im, lb, va = jmesh.shard_batch(m, inputs["images"], inputs["labels"].astype(np.int32),
                                   np.ones((B,), np.float32))
    state, met = train(state, im, lb, va)
    got = runs[("vit_test", (2, 2))][0]["train_step"]
    _close(got["loss"], float(met["loss_sum"]) / float(met["count"]), 1e-5, 0, "loss")
    for path, v in jtrees.flatten_with_paths(state.params).items():
        _close(got["params"][path], np.asarray(v), 0, 2.5e-3, path)


def test_sharded_pgd_matches_jax(runs, inputs):
    """PGD-3 without a random start (no draws) at (2, 2) against the JAX
    package's, within test_torch_attacks.py's agreement (99% of pixels
    within 1e-6)."""
    params = jtrees.unflatten_from_paths({p: jnp.asarray(v) for p, v in inputs["vit"].items()})
    want = jwb.make_pgd(jvit.apply, jvit.VIT_TEST, eps=EPS, alpha=3 / 255, steps=3,
                        random_start=False)(params, jnp.asarray(inputs["images"]),
                                            jnp.asarray(inputs["labels"]), jax.random.key(0))
    got = runs[("vit_test", (2, 2))][0]["pgd_fixed"]["adv"].numpy()
    ok = np.abs(got - np.asarray(want)) <= 1e-6
    assert ok.mean() >= 0.99, f"only {ok.mean():.4f} of pixels agree"
