"""Operations of the Swin programs, counted from the configuration's shapes:
the yardstick of the Swin cells' ``mfu_pct`` metrics.

Per image, with T_s = (res_s)² tokens and C_s channels in stage s, a
multiply-add two operations:

* the patch embedding, a dense of (P²·3, C_0) over T_0 patches;
* a block: the qkv, proj, fc1 and fc2 denses, 2·T·C·(3C + C + 4C + 4C) =
  24·C²·T (12·C²·T multiply-adds), and the window core, QKᵀ and PV over
  49-token windows, 4·49·C·T (2·49·C·T multiply-adds), the published
  count's; the shift, the mask and the bias are element-wise;
* a patch merging: a dense of (4C, 2C) over the T/4 merged tokens;
* the head, a dense of (C_last, classes) over the pooled token.

So ``forward`` is 2 × the published 15.4 GMAC of Swin-B at 224 px (Liu et
al., 2021, Table 1), within a few tenths of a percent. A backward for the
input is twice the forward's products (every dense's input gradient and the
core's four products); a PGD step is a forward and that backward.
Element-wise work is not counted.
"""

from __future__ import annotations


def _stages(cfg):
    for s, depth in enumerate(cfg.depths):
        yield s, depth, cfg.res(s) ** 2, cfg.dim(s)


def _patch_embed(cfg) -> int:
    return 2 * cfg.res(0) ** 2 * cfg.patch_size ** 2 * 3 * cfg.embed


def _core(cfg, tokens: int, dim: int) -> int:
    return 4 * cfg.window ** 2 * dim * tokens


def _denses(cfg) -> int:
    """Every dense once: patch embedding, blocks, mergings, head."""
    total = _patch_embed(cfg)
    last = len(cfg.depths) - 1
    for s, depth, t, c in _stages(cfg):
        hidden = int(c * cfg.mlp_ratio)
        total += depth * 2 * t * c * (3 * c + c + 2 * hidden)
        if s < last:
            total += 2 * (t // 4) * 4 * c * 2 * c
    return total + 2 * cfg.dim(last) * cfg.classes


def forward(cfg) -> int:
    return _denses(cfg) + sum(depth * _core(cfg, t, c) for _, depth, t, c in _stages(cfg))


def backward_input(cfg) -> int:
    """The input gradient: every dense's and the core's, nothing of the weights."""
    return _denses(cfg) + sum(depth * 2 * _core(cfg, t, c) for _, depth, t, c in _stages(cfg))


def pgd(cfg, steps: int) -> int:
    return steps * (forward(cfg) + backward_input(cfg))
