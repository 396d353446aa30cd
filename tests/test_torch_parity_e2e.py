"""End-to-end accuracy parity with three sides: HF ``transformers`` + PEFT
(``TorchSide``), the JAX package (``JaxSide``), both from
``tools/parity_e2e.py``, and the port (``PortSide``, the port's
``tools/parity_e2e.py``), at ``tests/test_parity_e2e.py``'s micro config
(1 epoch, 1 LoRA epoch, 8 / 2 / 6 images per class, PGD-3, batch 16).

The three start from one HF init and share the corpus and the batch orders;
each attacks its own trained model and trains its LoRA on its own
adversarial data; the LoRA init (factors and classifier copy) is the JAX
side's, read by the other two from one PEFT directory. Every cell of the 4
variants x 3 datasets accuracy matrix agrees within ±0.5% across the three.
"""

import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")
pytest.importorskip("peft")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.tools import parity_e2e as tpar  # noqa: E402
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import peft_io as jpeft  # noqa: E402
from tools import parity_e2e as jpar  # noqa: E402

TOL = 0.005
EPS, ALPHA, PGD_STEPS, LR, WD, BATCH = 8 / 255, 3 / 255, 3, 1e-4, 1e-4, 16


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """The experiment on the three sides: {"matrix": {variant: {dataset:
    {side: accuracy}}}, "losses": {side: per-step base losses}}."""
    root = tmp_path_factory.mktemp("parity3")
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    # PEFT looks the adapters' base model up on the hub unless offline; the
    # transformers import skips TensorFlow
    env = pytest.MonkeyPatch()
    env.setenv("HF_HUB_OFFLINE", "1")
    env.setenv("USE_TF", "0")
    try:
        corpus = jpar.make_corpus(8, 2, 6)
        n_train = len(corpus["train"][1])
        orders = jpar.batch_orders(np.random.default_rng(99), n_train, BATCH, 1)
        lora_orders = jpar.batch_orders(np.random.default_rng(100), n_train, BATCH, 1)

        ts = jpar.TorchSide(seed=0)
        js = jpar.JaxSide(ts.init_state)
        ps = tpar.PortSide(ts.init_state)
        losses = {"torch": ts.train_base(corpus, orders, LR, WD)}
        ts.init_state_trained = {k: v.detach().clone() for k, v in ts.model.state_dict().items()}
        losses["jax"] = js.train_base(corpus, orders, LR, WD)
        losses["port"] = ps.train_base(corpus, orders, LR, WD)

        attacks = {}
        for kind in ("fgsm", "pgd"):
            kw = dict(kind=kind, eps=EPS, alpha=ALPHA, steps=PGD_STEPS)
            attacks[kind] = {}
            for split in ("train", "test"):
                x, y = corpus[split]
                attacks[kind][split] = {"torch": (ts.attack_split(x, y, **kw), y),
                                        "jax": (js.attack_split(x, y, **kw), y),
                                        "port": (ps.attack_split(x, y, **kw), y)}

        trained_j, torch_dirs, port_dirs = {}, {}, {}
        for i, kind in enumerate(("fgsm", "pgd")):
            adapter0, lcfg = js.init_lora(seed=10 + i)
            init_dir = str(root / f"init_{kind}")
            jpeft.save_peft_adapter(adapter0, lcfg, init_dir, head={
                "w": js.params["head"]["w"], "b": js.params["head"]["b"]})
            trained_j[kind] = js.train_lora(adapter0, lcfg, attacks[kind]["train"]["jax"],
                                            lora_orders, LR)
            pm = ts.train_lora(init_dir, attacks[kind]["train"]["torch"], lora_orders, LR)
            out = str(root / f"torch_{kind}")
            pm.save_pretrained(out)
            torch_dirs[kind] = out if os.path.exists(os.path.join(out, "adapter_config.json")) \
                else os.path.join(out, "default")
            port_dirs[kind] = ps.train_lora(init_dir, attacks[kind]["train"]["port"],
                                            lora_orders, LR, str(root / f"port_{kind}"))

        def torch_model(combo):
            if not combo:
                m = __import__("copy").deepcopy(ts.model)
                m.load_state_dict(ts.init_state_trained)
                return m
            return ts.merged([torch_dirs[a] for a in combo])

        datasets = {"clean": {s: corpus["test"] for s in ("torch", "jax", "port")},
                    **{k: attacks[k]["test"] for k in ("fgsm", "pgd")}}
        variants = {"base": (), "lora_fgsm": ("fgsm",), "lora_pgd": ("pgd",),
                    "fgsm+pgd": ("fgsm", "pgd")}
        matrix = {}
        for vname, combo in variants.items():
            models = {"torch": torch_model(combo),
                      "jax": js.variant_params(trained_j, lcfg, combo) if combo else js.params,
                      "port": ps.merged([port_dirs[a] for a in combo])}
            accuracy = {"torch": ts.accuracy, "jax": js.accuracy, "port": ps.accuracy}
            matrix[vname] = {dname: {side: accuracy[side](models[side], *sides[side])
                                     for side in ("torch", "jax", "port")}
                             for dname, sides in datasets.items()}
    finally:
        torch.set_num_threads(saved)
        env.undo()
    return {"matrix": matrix, "losses": losses}


def test_the_three_sides_agree_on_every_cell(experiment):
    matrix = experiment["matrix"]
    assert list(matrix) == ["base", "lora_fgsm", "lora_pgd", "fgsm+pgd"]
    for vname, per_ds in matrix.items():
        assert list(per_ds) == ["clean", "fgsm", "pgd"]
        for dname, acc in per_ds.items():
            assert 0.0 <= acc["port"] <= 1.0
            for a, b in (("port", "jax"), ("port", "torch"), ("jax", "torch")):
                assert abs(acc[a] - acc[b]) <= TOL, (vname, dname, acc)


def test_the_base_fine_tune_follows_the_same_losses(experiment):
    """The port's per-step losses against the JAX side's and HF's (f32, one
    shared init and batch order)."""
    losses = experiment["losses"]
    assert len(losses["port"]) == len(losses["jax"]) == len(losses["torch"]) == 6
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(losses["port"], losses["torch"], rtol=1e-4, atol=1e-5)


def test_the_corpus_copy_is_the_tools_corpus():
    got, want = tpar.make_corpus(2, 1, 1), jpar.make_corpus(2, 1, 1)
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(got[split][0], want[split][0])
        np.testing.assert_array_equal(got[split][1], want[split][1])
    rng = lambda: np.random.default_rng(7)  # noqa: E731
    for a, b in zip(tpar.batch_orders(rng(), 40, 16, 2), jpar.batch_orders(rng(), 40, 16, 2)):
        assert [list(x) for x in a] == [list(x) for x in b]
