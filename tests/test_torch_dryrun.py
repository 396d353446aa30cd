"""The port's counterpart of ``__graft_entry__``: ``parallel.dryrun.entry``
and ``dryrun_multichip`` on gloo on the CPU (as tests/test_graft_entry.py
runs the JAX one on the virtual CPU mesh), the launcher's backend rule, and
no quiet move from the card to the CPU."""

import pytest
import torch

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.parallel import dryrun, launch
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.parallel import mesh as tmesh


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # the ranks take one thread each; so does this process beside them
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_entry_runs_the_lora_vit_b16_forward():
    fn, (model, images) = dryrun.entry(device="cpu")
    assert images.shape == (8, 224, 224, 3)
    assert any(n.endswith("lora_a") for n, _ in model.named_parameters())
    with torch.no_grad():
        out = fn(model, images[:1])
    assert out.shape == (1, 21) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())


def test_dryrun_multichip_4_on_the_cpu():
    dryrun.dryrun_multichip(4, device="cpu")


def test_dryrun_module_entry_point_2_on_the_cpu(capsys):
    dryrun.main(["--n", "2", "--device", "cpu"])
    assert "dryrun_multichip(2, device='cpu'): passed" in capsys.readouterr().out


def test_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.dryrun_multichip(2, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_mesh(tmesh.MeshSpec(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.spawn(print, 2, device="cuda")


def test_backend_rule(monkeypatch):
    assert launch.backend_for(4, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for cards, n, want in ((1, 4, "gloo"), (1, 1, "nccl"), (4, 4, "nccl"), (2, 4, "gloo")):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=cards: c)
        assert launch.backend_for(n, "cuda") == want, (cards, n)
        assert launch.rank_device(3, "cuda") == torch.device("cuda", 3 % cards)
    assert launch.rank_device(3, "cpu") == torch.device("cpu")


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_mesh(tmesh.MeshSpec(), device="cpu")
