"""What the drivers share: the program's entry for a configuration, the host
pool of batches, the program's counters and the device's clock edge."""

from __future__ import annotations

import importlib

import numpy as np

PORT = "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch"
KERNEL_MODULES = ("attention", "window_attention", "attn_block", "mlp", "dwconv")


def port(name: str):
    """``<port>.<name>``: the program is imported on its side of a run only."""
    return importlib.import_module(f"{PORT}.{name}")


def program(cell):
    """(registry entry, the program's config) of the cell's configuration,
    the program's config held to the file's widths."""
    conf = cell.config
    entry = port("models.registry").get_model(conf["registry"])
    cfg = entry.config(conf["num_labels"])
    want = cell.family.port_fields(conf)
    have = {k: getattr(cfg, k) for k in want}
    if have != want:
        bad = {k: (have[k], want[k]) for k in want if have[k] != want[k]}
        raise ValueError(f"{conf['registry']}: the program's config differs from "
                         f"{cell.config_name}'s file (program, file): {bad}")
    return entry, cfg


POOL_BATCHES = 8  # the host pool's batches, which the window cycles through


def host_pool(seed: int, batch: int, size: int, classes: int):
    """``POOL_BATCHES`` batches of uint8 NHWC images and int64 labels, made
    on the host from the seed: the same seed gives the same pool."""
    rng = np.random.default_rng(seed % 2 ** 64)
    images = rng.integers(0, 256, size=(POOL_BATCHES, batch, size, size, 3), dtype=np.uint8)
    labels = rng.integers(0, classes, size=(POOL_BATCHES, batch), dtype=np.int64)
    return images, labels


def counters() -> dict:
    """The program's launch and call counters: {"module.NAME": count}."""
    out = {}
    for name in KERNEL_MODULES:
        mod = port(f"kernels.{name}")
        out.update({f"{name}.{k}": v for k, v in vars(mod).items()
                    if k.isupper() and k.endswith(("_LAUNCHES", "_CALLS")) and isinstance(v, int)})
    return out


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
