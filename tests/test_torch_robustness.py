"""The port's robustness runner (``<port>/tools/run_robustness.py``).

* The marker rules, with the stage process replaced by a recorder (as
  ``tests/test_run_robustness_resume.py`` does for the JAX runner): a
  matching marker skips its stage; a changed argument reruns that stage and
  every stage that reads its outputs; a family added on resume trains that
  family alone; eval-compose always runs; a failed stage is retried once in
  a new process, then ends the run and leaves no marker.
* Paths: a relative ``--workdir`` and ``--out`` are taken from the caller's
  working directory (the stages run from the repository's root, so every
  path handed to them is absolute); the default artifact names no committed
  file.
* One real ``--quick --device cpu`` run (``vit_test``, 32 px): eight stages,
  the 27-variant x 6-dataset matrix, a ``--resume`` run that reruns only
  eval-compose with the same accuracies; then the JAX CLI's ``eval-compose``
  over the port run's workdir (checkpoint, PNGs, adapters) gives the port's
  ``test_results.json``: accuracies equal, F1 and loss within rtol 1e-4.
"""

import glob
import json
import os
import re
import subprocess

import numpy as np
import pytest

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.tools import run_robustness as rr
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.cli.main import main as jmain

STAGES = ["synth-data", "train", "attack", "patch-attack", "autoattack", "rp2-attack",
          "train-lora", "eval-compose"]


class Recorder:
    """Stands in for a stage process: records each argument list; eval-compose
    writes a one-cell matrix; ``fail`` maps a subcommand to the exit codes it
    returns, in turn."""

    def __init__(self, fail=None):
        self.calls: list[list[str]] = []
        self.fail = {k: list(v) for k, v in (fail or {}).items()}

    def __call__(self, argv):
        self.calls.append(argv)
        command = argv[2]
        if self.fail.get(command):
            return self.fail[command].pop(0), "failed\n"
        if command == "eval-compose":
            out = argv[argv.index("--output_dir") + 1]
            os.makedirs(out, exist_ok=True)
            with open(os.path.join(out, "test_results.json"), "w") as f:
                json.dump({"base": {"clean": {"accuracy": 0.5}}}, f)
        return 0, "ran\n"

    def commands(self):
        return [argv[2] for argv in self.calls]

    def attacks(self, command="train-lora"):
        argv = next(a for a in self.calls if a[2] == command)
        i = argv.index("--attacks") + 1
        return argv[i:i + next((k for k, a in enumerate(argv[i:]) if a.startswith("--")),
                               len(argv) - i)]


def _run(tmp_path, *extra, recorder=None, resume=False):
    recorder = recorder or Recorder()
    art = rr.main(["--workdir", str(tmp_path / "w"), "--out", str(tmp_path / "a.json"),
                   "--device", "cpu", *(["--resume"] if resume else []), *extra],
                  launch=recorder)
    return recorder, art


def test_first_run_runs_every_stage_in_order_with_the_device(tmp_path):
    rec, art = _run(tmp_path)
    assert rec.commands() == STAGES
    assert all(argv[:2] == ["--device", "cpu"] for argv in rec.calls)
    assert rec.attacks() == list(rr.FAMILIES)
    assert [s["stage"] for s in art["stages"]] == [
        "synth-data", "train", "attack-whitebox", "attack-patch", "attack-autoattack",
        "attack-rp2", "train-lora", "eval-compose"]
    assert set(art) == {"config", "stages", "total_seconds", "matrix"}
    assert art["config"]["image_size"] == 224 and art["config"]["model"] == "google_vit"


def test_matching_markers_skip_every_stage_but_eval_compose(tmp_path):
    _run(tmp_path)
    rec, art = _run(tmp_path, resume=True)
    assert rec.commands() == ["eval-compose"]
    assert [s.get("resumed", False) for s in art["stages"]] == [True] * 7 + [False]


def test_markers_are_ignored_without_resume(tmp_path):
    _run(tmp_path)
    rec, _ = _run(tmp_path)
    assert rec.commands() == STAGES


@pytest.mark.parametrize("change, reruns", [
    (["--patch_iters", "7"], ["patch-attack", "train-lora", "eval-compose"]),
    (["--lora_epochs", "2"], ["train-lora", "eval-compose"]),
    (["--epochs", "3"], STAGES[1:]),
    (["--n_per_class", "5"], STAGES),
])
def test_a_changed_argument_reruns_its_stage_and_every_reader(tmp_path, change, reruns):
    _run(tmp_path)
    rec, _ = _run(tmp_path, *change, resume=True)
    assert rec.commands() == reruns
    if change[0] == "--patch_iters":
        assert rec.attacks() == ["patch_circle"]  # the other families' markers match
    elif "train-lora" in reruns:
        assert rec.attacks() == list(rr.FAMILIES)


def test_a_family_added_on_resume_trains_that_family_alone(tmp_path, monkeypatch):
    monkeypatch.setattr(rr, "FAMILIES", rr.FAMILIES[:-1])
    first, _ = _run(tmp_path)
    assert first.attacks() == ["fgsm", "pgd", "patch_circle", "autoattack"]
    monkeypatch.undo()
    rec, art = _run(tmp_path, resume=True)
    assert rec.commands() == ["train-lora", "eval-compose"]
    assert rec.attacks() == ["rp2"]
    assert rec.attacks("eval-compose") == list(rr.FAMILIES)
    assert art["stages"][6] == {**art["stages"][6], "stage": "train-lora", "families": ["rp2"]}


def test_a_failed_stage_is_retried_once_then_ends_the_run(tmp_path):
    rec, art = _run(tmp_path, recorder=Recorder({"attack": [1]}))
    assert rec.commands().count("attack") == 2
    assert [s["rc"] for s in art["stages"] if s["stage"] == "attack-whitebox"] == [1, 0]
    with pytest.raises(RuntimeError, match="attack-patch failed after 2 attempts"):
        _run(tmp_path, "--patch_iters", "7", recorder=Recorder({"patch-attack": [1, 1]}),
             resume=True)
    assert not os.path.exists(tmp_path / "w" / "markers" / "attack-patch.json")
    rec, _ = _run(tmp_path, resume=True)
    assert rec.commands() == ["patch-attack", "train-lora", "eval-compose"]


PATH_FLAGS = ("--output_dir", "--data_root", "--model_path", "--adv_root", "--lora_root",
              "--stats_json")


def test_a_relative_workdir_and_out_are_taken_from_the_callers_cwd(tmp_path, monkeypatch):
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    rec = Recorder()
    art = rr.main(["--workdir", "relwd", "--out", "rel.json", "--device", "cpu"], launch=rec)
    work = str(cwd / "relwd")
    paths = [argv[i + 1] for argv in rec.calls for i, a in enumerate(argv[:-1]) if a in PATH_FLAGS]
    # every stage gets its output directory; the model stages their data and checkpoint too
    assert len(paths) >= 2 * len(STAGES)
    for path in paths:
        assert os.path.isabs(path) and path.startswith(work + os.sep), path
    assert sorted(os.listdir(cwd / "relwd" / "markers")) == sorted(
        [f"{k}.json" for k in rr.INPUTS] + [f"train-lora.{f}.json" for f in rr.FAMILIES])
    assert os.path.exists(cwd / "relwd" / "eval" / "test_results.json")
    with open(cwd / "rel.json") as f:
        assert json.load(f)["matrix"] == art["matrix"] == {"base": {"clean": {"accuracy": 0.5}}}


def _committed_files() -> set:
    """The repository's files as git lists them, where the checkout is a git
    work tree of its own; otherwise (an archive copy, perhaps inside another
    repository) the committed robustness artifacts on disk."""
    def git(*args):
        return subprocess.run(["git", *args], cwd=rr.REPO, capture_output=True, text=True,
                              check=True, timeout=60).stdout
    try:
        if os.path.realpath(git("rev-parse", "--show-toplevel").strip()) == \
                os.path.realpath(rr.REPO):
            return set(git("ls-files").splitlines())
    except (OSError, subprocess.CalledProcessError):
        pass
    return {os.path.basename(p) for p in glob.glob(os.path.join(rr.REPO, "ROBUSTNESS*_r*.json"))}


def test_the_default_artifact_names_no_committed_file():
    default = rr.build_parser().get_default("out")
    committed = _committed_files()
    assert "ROBUSTNESS_r04.json" in committed  # the list is the repository's
    assert os.path.basename(default) == default and default not in committed
    assert not re.fullmatch(r"ROBUSTNESS\w*_r\d+\.json", default)


def test_quick_run_on_the_cpu_and_the_jax_cli_reads_its_workdir(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    work = tmp_path / "w"
    art = rr.main(["--quick", "--device", "cpu", "--workdir", str(work),
                   "--out", str(tmp_path / "a.json")])
    assert [s["rc"] for s in art["stages"]] == [0] * 8
    matrix = art["matrix"]
    assert len(matrix) == 27 and all(len(per) == 6 for per in matrix.values())
    assert all(0.0 <= m["accuracy"] <= 1.0 for per in matrix.values() for m in per.values())
    assert art["aa_attribution"]["n_iter"] == 2

    again = rr.main(["--quick", "--device", "cpu", "--workdir", str(work), "--resume",
                     "--out", str(tmp_path / "b.json")])
    assert [s.get("resumed", False) for s in again["stages"]] == [True] * 7 + [False]
    assert {v: {d: m["accuracy"] for d, m in per.items()} for v, per in again["matrix"].items()} \
        == {v: {d: m["accuracy"] for d, m in per.items()} for v, per in matrix.items()}

    ck = str(work / "train" / "vit_test" / "all" / "vit_test_best_model_finetuned.safetensors")
    assert jmain(["--platform", "cpu", "eval-compose", "--data_root", str(work / "data"),
                  "--model", "vit_test", "--model_path", ck, "--adv_root", str(work / "adv"),
                  "--lora_root", str(work / "loras"), "--output_dir", str(tmp_path / "jax"),
                  "--attacks", *rr.FAMILIES, "--rank", "8", "--batch_size", "64"]) == 0
    want = json.load(open(tmp_path / "jax" / "test_results.json"))
    assert list(matrix) == list(want)
    for variant, per_ds in want.items():
        assert list(matrix[variant]) == list(per_ds)
        for ds, m in per_ds.items():
            g = matrix[variant][ds]
            assert g["accuracy"] == m["accuracy"] and g["support"] == m["support"]
            np.testing.assert_allclose(g["f1"], m["f1"], rtol=1e-4)
            np.testing.assert_allclose(g["loss"], m["loss"], rtol=1e-4)
