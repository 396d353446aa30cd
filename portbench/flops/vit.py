"""Operations of the ViT programs, counted from the configuration's shapes:
the yardstick of the ViT cells' ``mfu_pct`` metrics.

A frozen copy of the program's own count (``tools/flops.py`` of the port, as
it stood when this benchmark was written), over the reference's
configuration (``reference/vit.Cfg``). N is the configuration's tokens (the
patches and the CLS token) with no padding, and a multiply-add is two
operations. Per image:

* a dense of (in, out) over R rows: 2·R·in·out, forward, input gradient and
  weight gradient alike; the patch embedding runs over the patches, the
  blocks over N tokens, the head over the CLS token;
* the attention core: 4·N²·D forward, 8·N²·D backward;
* a rank-r LoRA branch on a target dense: 2·R·r·(in + out) for each of the
  forward, the input gradient and the factors' gradient.

Backward kinds: ``input`` (the attack's: every input gradient, the patch
embedding's too, no weight gradient), ``full`` (a full fine-tune's: no
image gradient, every weight's gradient), ``lora`` (no image gradient, the
factors' gradients; with ``train_head``, the head's weight gradient too).
Element-wise work is not counted.
"""

from __future__ import annotations

TARGETS = ("q", "k", "v", "o")


def _dense(rows: int, d_in: int, d_out: int) -> int:
    return 2 * rows * d_in * d_out


def _patches(cfg) -> tuple[int, int, int]:
    return cfg.tokens - 1, cfg.patch_size * cfg.patch_size * 3, cfg.hidden


def _block_denses(cfg) -> dict:
    n, d, m = cfg.tokens, cfg.hidden, cfg.mlp
    return {"q": (n, d, d), "k": (n, d, d), "v": (n, d, d), "o": (n, d, d),
            "fc1": (n, d, m), "fc2": (n, m, d)}


def _branch(cfg, rank: int, targets) -> int:
    shapes = _block_denses(cfg)
    return cfg.depth * sum(2 * shapes[t][0] * rank * (shapes[t][1] + shapes[t][2])
                           for t in targets) if rank else 0


def _core(cfg) -> int:
    return 4 * cfg.tokens * cfg.tokens * cfg.hidden


def _all_denses(cfg) -> int:
    blocks = cfg.depth * sum(_dense(*s) for s in _block_denses(cfg).values())
    return _dense(*_patches(cfg)) + blocks + _dense(1, cfg.hidden, cfg.classes)


def forward(cfg, *, rank: int = 0, targets=TARGETS) -> int:
    return _all_denses(cfg) + cfg.depth * _core(cfg) + _branch(cfg, rank, targets)


def backward(cfg, kind: str, *, rank: int = 0, targets=TARGETS, train_head: bool = False) -> int:
    dx = _all_denses(cfg) + cfg.depth * 2 * _core(cfg) + _branch(cfg, rank, targets)
    if kind == "input":
        return dx
    dx -= _dense(*_patches(cfg))  # the images ask no gradient in training
    if kind == "full":
        return dx + _all_denses(cfg)
    if kind == "lora":
        head = _dense(1, cfg.hidden, cfg.classes) if train_head else 0
        return dx + _branch(cfg, rank, targets) + head
    raise ValueError(f"backward kind {kind!r}: input, full or lora")


def pgd(cfg, steps: int) -> int:
    """FLOP per image of PGD-``steps``: a forward and an input gradient a step."""
    return steps * (forward(cfg) + backward(cfg, "input"))


def train_step(cfg, mode: str, *, rank: int = 8, targets=TARGETS,
               train_head: bool = False) -> int:
    """FLOP per image of one training step, ``mode`` "full" or "lora"."""
    if mode == "full":
        return forward(cfg) + backward(cfg, "full")
    if mode == "lora":
        return (forward(cfg, rank=rank, targets=targets)
                + backward(cfg, "lora", rank=rank, targets=targets, train_head=train_head))
    raise ValueError(f"train mode {mode!r}: full or lora")
