"""End-to-end accuracy parity with three sides: HF ``transformers`` + PEFT
(``TorchSide``), the JAX package (``JaxSide``), both from
``tools/parity_e2e.py``, and the port (``PortSide``, the port's
``tools/parity_e2e.py``), run by the root script ``parity_e2e_torch.py`` at
``tests/test_parity_e2e.py``'s micro config (1 epoch, 1 LoRA epoch, 8 / 2 /
6 images per class, PGD-3, batch 16) with the port on the CPU.

The three start from one HF init and share the corpus and the batch orders;
each attacks its own trained model and trains its LoRA on its own
adversarial data; the LoRA init (factors and classifier copy) is the JAX
side's, read by the other two from one PEFT directory. Every cell of the 4
variants x 3 datasets accuracy matrix agrees within ±0.5% across the three.
The runner's ``--full`` switch and its handling of the JAX tool's module
globals are checked with stub sides, without running ViT-B.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")
pytest.importorskip("peft")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import parity_e2e_torch as runner  # noqa: E402
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.tools import parity_e2e as tpar  # noqa: E402
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import lora as jlora  # noqa: E402
from tools import parity_e2e as jpar  # noqa: E402

TOL = 0.005
EPS, ALPHA, PGD_STEPS, LR, WD, BATCH = 8 / 255, 3 / 255, 3, 1e-4, 1e-4, 16
COUNTS = (8, 2, 6)  # images per class: train, val, test
STAGES = {"base", "attacks", "lora", "matrix"}
MICRO = ["--epochs", "1", "--lora_epochs", "1", "--n_train", str(COUNTS[0]),
         "--n_val", str(COUNTS[1]), "--n_test", str(COUNTS[2]), "--pgd_steps", str(PGD_STEPS),
         "--batch", str(BATCH), "--device", "cpu"]
# the JAX tool's artifact keys (tools/parity_e2e.py main)
TOOL_KEYS = ("protocol", "train_loss_max_abs_diff", "matrix", "max_abs_acc_diff", "ok", "seconds")
TOOL_PROTOCOL_KEYS = ("classes", "image_size", "geometry", "hf_cfg", "n_train", "n_test",
                      "epochs", "lora_epochs", "eps", "alpha", "pgd_steps", "pgd_random_start",
                      "lr", "wd", "lora_rank", "lora_targets", "tol")


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """The experiment on the three sides through the runner: its exit code,
    the artifact it wrote and its work directory (the LoRA inits)."""
    root = tmp_path_factory.mktemp("parity3")
    out = root / "parity.json"
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = runner.main([*MICRO, "--out", str(out)], workdir=str(root))
    finally:
        torch.set_num_threads(saved)
    with open(out) as f:
        return {"rc": rc, "artifact": json.load(f), "root": root}


def test_the_three_sides_agree_on_every_cell(experiment):
    art = experiment["artifact"]
    assert experiment["rc"] == 0 and art["ok"]
    matrix = art["matrix"]
    assert list(matrix) == ["base", "lora_fgsm", "lora_pgd", "fgsm+pgd"]
    for vname, per_ds in matrix.items():
        assert list(per_ds) == ["clean", "fgsm", "pgd"]
        for dname, acc in per_ds.items():
            assert 0.0 <= acc["port"] <= 1.0
            for a, b in (("port", "jax"), ("port", "torch"), ("jax", "torch")):
                assert abs(acc[a] - acc[b]) <= TOL, (vname, dname, acc)
    assert art["max_abs_acc_diff"] <= TOL and art["max_port_vs_jax_acc_diff"] <= TOL


def test_the_base_fine_tune_follows_the_same_losses(experiment):
    """The port's per-step losses against the JAX side's and HF's (f32, one
    shared init and batch order)."""
    losses = experiment["artifact"]["train_losses"]
    assert len(losses["port"]) == len(losses["jax"]) == len(losses["torch"]) == 6
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(losses["port"], losses["torch"], rtol=1e-4, atol=1e-5)
    assert experiment["artifact"]["port_train_loss_max_abs_diff"] == pytest.approx(
        np.max(np.abs(np.subtract(losses["port"], losses["jax"]))))


def test_the_corpus_copy_is_the_tools_corpus():
    got, want = tpar.make_corpus(2, 1, 1), jpar.make_corpus(2, 1, 1)
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(got[split][0], want[split][0])
        np.testing.assert_array_equal(got[split][1], want[split][1])
    rng = lambda: np.random.default_rng(7)  # noqa: E731
    for a, b in zip(tpar.batch_orders(rng(), 40, 16, 2), jpar.batch_orders(rng(), 40, 16, 2)):
        assert [list(x) for x in a] == [list(x) for x in b]


def test_the_artifact_has_the_tools_keys_and_a_port_value_in_every_cell(experiment):
    art = experiment["artifact"]
    assert set(TOOL_KEYS) <= set(art)
    assert set(TOOL_PROTOCOL_KEYS) <= set(art["protocol"])
    assert art["protocol"]["geometry"] == "tiny" and art["protocol"]["hf_cfg"] == jpar.HF_CFG
    assert art["protocol"]["lora_targets"] == list(jpar.LORA_TARGETS)
    assert art["protocol"]["n_train"] == 12 * COUNTS[0]
    assert art["protocol"]["n_test"] == 12 * COUNTS[2]
    for per_ds in art["matrix"].values():
        for acc in per_ds.values():
            assert set(acc) == {"torch", "jax", "port", "abs_diff"}
            assert acc["abs_diff"] == pytest.approx(
                max(acc[s] for s in runner.SIDES) - min(acc[s] for s in runner.SIDES), abs=1e-4)
    for kind in tpar.ATTACKS:
        fracs = art["adv_test_uint8_mismatch"][kind]
        assert set(fracs) == {"port_vs_jax", "torch_vs_jax"}
        assert all(0.0 <= f <= 1.0 for f in fracs.values())
    assert {side: set(s) for side, s in art["stage_seconds"].items()} == {
        side: STAGES for side in runner.SIDES}
    assert art["host"]["torch_threads"] == 1 and art["host"]["cpu"]
    # the cut counts, each beside the tool's default
    assert art["protocol"]["cuts"]["n_train"] == {"used": COUNTS[0], "tool_default": 32}


def test_run_port_side_alone_gives_the_fixtures_matrix(experiment, tmp_path):
    """``run_port_side`` on a fresh ``PortSide`` from the same HF init, corpus,
    orders and LoRA inits: the runner's port values, losses and all."""
    art, root = experiment["artifact"], experiment["root"]
    side = tpar.PortSide(jpar.TorchSide(seed=0).init_state, device="cpu")
    corpus = tpar.make_corpus(*COUNTS)
    n = len(corpus["train"][1])
    orders = tpar.batch_orders(np.random.default_rng(99), n, BATCH, 1)
    lora_orders = tpar.batch_orders(np.random.default_rng(100), n, BATCH, 1)
    called = []

    def lora_init(s, kind, index):
        assert s is side and s.tree is not None  # after stage 1
        called.append((kind, index))
        return str(root / f"init_{kind}")

    got = tpar.run_port_side(side, corpus, orders, lora_orders, lora_init, str(tmp_path),
                             eps=EPS, alpha=ALPHA, pgd_steps=PGD_STEPS, lr=LR, wd=WD)
    assert called == [("fgsm", 0), ("pgd", 1)]
    assert got["losses"] == art["train_losses"]["port"]
    assert {v: {d: round(a, 4) for d, a in per.items()} for v, per in got["matrix"].items()} == \
        {v: {d: cell["port"] for d, cell in per.items()} for v, per in art["matrix"].items()}
    assert got["adapters"] == {k: str(tmp_path / f"port_{k}") for k in tpar.ATTACKS}
    for kind in tpar.ATTACKS:
        for split in ("train", "test"):
            adv = got["adv"][kind][split]
            assert adv.dtype == np.uint8 and adv.shape == corpus[split][0].shape
    assert set(got["seconds"]) == STAGES


def test_the_port_side_leaves_the_init_state_dict_as_it_was():
    """Two sides from one HF state dict (as ``chip_smoke.py`` phase 12 builds
    the CPU and the card side) start from the same weights: the first
    side's base fine-tune trains copies, not the dict's tensors."""
    state = jpar.TorchSide(seed=0).init_state
    before = {k: v.clone() for k, v in state.items()}
    corpus = tpar.make_corpus(1, 1, 1)
    orders = tpar.batch_orders(np.random.default_rng(99), 12, 12, 1)
    first = tpar.PortSide(state, device="cpu").train_base(corpus, orders, LR, WD)
    assert all(torch.equal(state[k], v) for k, v in before.items())
    assert tpar.PortSide(state, device="cpu").train_base(corpus, orders, LR, WD) == first


def test_the_constants_equal_the_tools():
    assert tpar.FULL_HF_CFG == jpar.FULL_HF_CFG
    assert tpar.LORA_TARGETS == jpar.LORA_TARGETS
    assert tpar.N_CLASSES == jpar.N_CLASSES


def _committed_files() -> set:
    """The repository's files as git lists them, where the checkout is a git
    work tree of its own; otherwise the parity artifacts on disk."""
    def git(*args):
        return subprocess.run(["git", *args], cwd=REPO, capture_output=True, text=True,
                              check=True, timeout=60).stdout
    try:
        if os.path.realpath(git("rev-parse", "--show-toplevel").strip()) == \
                os.path.realpath(REPO):
            return set(git("ls-files").splitlines())
    except (OSError, subprocess.CalledProcessError):
        pass
    return {os.path.basename(p) for p in glob.glob(os.path.join(REPO, "PARITY_E2E*.json"))}


def test_the_default_out_names_no_committed_file():
    default = runner.parser().get_default("out")
    committed = _committed_files()
    assert "PARITY_E2E_r04.json" in committed  # the list is the repository's
    assert os.path.basename(default) == default and default not in committed


# ---------------------------------------------------------------- stub sides


class _Stubs:
    """Sides that record the geometry they are given and do no work; the
    port's raises in ``raise_in`` when set."""

    def __init__(self, raise_in=None):
        self.seen, self.raise_in = {}, raise_in
        stubs = self

        class TorchSide:
            def __init__(self, seed):
                stubs.seen["torch"] = (dict(jpar.HF_CFG), jpar.IMG)
                self.model = torch.nn.Linear(1, 1)
                self.init_state = self.model.state_dict()

            def train_base(self, corpus, orders, lr, wd):
                stubs.seen["torch_corpus"] = corpus["train"][0].shape[1:3]
                return [1.0]

            def attack_split(self, x, y, **kw):
                return x

            def train_lora(self, init_dir, adv, orders, lr):
                class Peft:
                    def save_pretrained(self, out):
                        os.makedirs(out)
                        open(os.path.join(out, "adapter_config.json"), "w").close()
                return Peft()

            def merged(self, dirs):
                return self.model

            def accuracy(self, model, x, y):
                return 0.5

        class JaxSide:
            def __init__(self, state_dict):
                stubs.seen["jax"] = (dict(jpar.HF_CFG), jpar.IMG)
                self.params = {"head": {"w": np.zeros((1, 12), np.float32),
                                        "b": np.zeros(12, np.float32)}}

            def train_base(self, corpus, orders, lr, wd):
                stubs.seen["jax_corpus"] = corpus["train"][0].shape[1:3]
                return [1.0]

            def attack_split(self, x, y, **kw):
                return x

            def init_lora(self, seed):
                return {}, jlora.LoRAConfig(rank=8, alpha=16.0, dropout=0.0, targets=())

            def train_lora(self, adapter, lcfg, adv, orders, lr):
                return {}

            def variant_params(self, trained, lcfg, combo):
                return self.params

            def accuracy(self, params, x, y):
                return 0.5

        class PortSide:
            def __init__(self, hf_state_dict, *, hf_cfg, device):
                stubs.seen["port"] = (dict(hf_cfg), hf_cfg["image_size"])
                stubs.seen["port_device"] = device

            def train_base(self, corpus, orders, lr, wd):
                stubs.seen["port_corpus"] = corpus["train"][0].shape[1:3]
                if stubs.raise_in == "port":
                    raise RuntimeError("stub side failed")
                return [1.0]

            def attack_split(self, x, y, **kw):
                return x

            def train_lora(self, init_dir, adv, orders, lr, out_dir):
                return out_dir

            def merged(self, dirs):
                return None

            def accuracy(self, model, x, y):
                return 0.5

        self.sides = {"TorchSide": TorchSide, "JaxSide": JaxSide, "PortSide": PortSide}

    def install(self, monkeypatch):
        monkeypatch.setattr(jpar, "TorchSide", self.sides["TorchSide"])
        monkeypatch.setattr(jpar, "JaxSide", self.sides["JaxSide"])
        monkeypatch.setattr(tpar, "PortSide", self.sides["PortSide"])


STUB_ARGS = ["--n_train", "1", "--n_val", "1", "--n_test", "1", "--batch", "12",
             "--epochs", "1", "--lora_epochs", "1", "--device", "cpu"]


def test_full_gives_every_side_vit_b_and_224_px_corpora(tmp_path, monkeypatch):
    stubs = _Stubs()
    stubs.install(monkeypatch)
    out = tmp_path / "full.json"
    assert runner.main(["--full", *STUB_ARGS, "--out", str(out)], workdir=str(tmp_path)) == 0
    full = (tpar.FULL_HF_CFG, 224)
    assert stubs.seen["torch"] == stubs.seen["jax"] == stubs.seen["port"] == full
    assert stubs.seen["port_device"] == "cpu"
    assert stubs.seen["torch_corpus"] == stubs.seen["jax_corpus"] == stubs.seen["port_corpus"] \
        == (224, 224)
    with open(out) as f:
        art = json.load(f)
    assert art["protocol"]["geometry"] == "full_vit_b"
    assert art["protocol"]["hf_cfg"] == tpar.FULL_HF_CFG and art["protocol"]["image_size"] == 224


def test_the_tools_globals_are_restored_after_a_run_and_after_a_raise(tmp_path, monkeypatch):
    before = (dict(jpar.HF_CFG), jpar.IMG, os.environ.get("HF_HUB_OFFLINE"))
    _Stubs().install(monkeypatch)
    assert runner.main(["--full", *STUB_ARGS, "--out", str(tmp_path / "a.json")],
                       workdir=str(tmp_path / "a")) == 0
    assert (jpar.HF_CFG, jpar.IMG, os.environ.get("HF_HUB_OFFLINE")) == before
    assert jpar.IMG == 32

    stubs = _Stubs(raise_in="port")
    stubs.install(monkeypatch)
    with pytest.raises(RuntimeError, match="stub side failed"):
        runner.main(["--full", *STUB_ARGS, "--out", str(tmp_path / "b.json")],
                    workdir=str(tmp_path / "b"))
    assert stubs.seen["port_corpus"] == (224, 224)  # it raised inside the full-geometry run
    assert (jpar.HF_CFG, jpar.IMG, os.environ.get("HF_HUB_OFFLINE")) == before
    assert not os.path.exists(tmp_path / "b.json")


def test_the_runner_refuses_the_card_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        runner.main(["--out", str(tmp_path / "x.json")])
    assert runner.parser().get_default("device") == "cuda"
