"""Square Attack (Linf) — black-box random search, forward passes only.

Counterpart of the JAX package's ``attacks/autoattack/square.py``: the Linf
Square Attack (Andriushchenko et al., ECCV 2020), the last stage of the
AutoAttack 'standard' suite. Per-example accept/reject is a batched margin
comparison; the host looks at the margins once per ``exit_check_every``
queries only, and stops when every example is adversarial (each further
query would be a no-op by the accept rule), as the JAX ``while_loop`` does.
Margins are computed from f32 logits; the model's parameters are frozen
while the attack runs.

Algorithm: start from vertical-stripe initialization
``x + eps·sign(U)`` per column; each query samples a square window (side
from the paper's ``p``-schedule) at a random position and proposes a new
constant ``±eps`` perturbation on that window per channel; accept when the
margin loss decreases. Examples already adversarial stop updating.

Deliberate divergences from the upstream ``autoattack`` library (documented
choices, tested in tests/test_autoattack.py):

========================  =================================  ==================
aspect                    upstream (square.py)               here
========================  =================================  ==================
p-schedule granularity    ``int(it/n*10000)`` breakpoints    identical formula
                          at 10/50/200/.../8000              (p_schedule());
                                                             square sides are
                                                             precomputed as a
                                                             static per-query
                                                             array so the scan
                                                             has fixed shapes
proposal dtype/space      candidate = x_window replaced by   same: window reset
                          ``clip(x0 + delta)``, delta        to x0 ± eps then
                          sampled per channel                ball∩box projected
accept rule               margin decreased AND example       same predicate,
                          still classified correctly         vectorized where()
                          (idx_to_fool re-batching)          instead of
                                                             re-batching (no
                                                             dynamic shapes)
tie-break CE loss         tracks CE alongside margin for     margin only: the
                          equal-margin acceptance            CE tie-break only
                                                             reorders equal-
                                                             margin proposals;
                                                             omitting it leaves
                                                             accept/reject and
                                                             success counting
                                                             unchanged
========================  =================================  ==================
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, Optional

import torch

from ...parallel import mesh as pmesh
from ..common import IMAGENET, Normalizer, frozen, linf_project, to_unit_floats
from .apgd import take_class


@dataclasses.dataclass(frozen=True)
class SquareConfig:
    eps: float = 8 / 255
    n_queries: int = 5000
    p_init: float = 0.8
    # queries between two looks at the margins: the search stops at such a
    # look once every example is adversarial
    exit_check_every: int = 100


def p_schedule(i: int, n: int, p_init: float) -> float:
    """Piecewise-constant fraction of pixels to perturb — the official
    schedule (query-fraction breakpoints 0.1%/0.5%/2%/5%/10%/20%/40%/60%/80%
    halving p at each, down to p_init/512)."""
    it = int(i / n * 10000)
    for bound, div in ((10, 1), (50, 2), (200, 4), (500, 8), (1000, 16), (2000, 32),
                       (4000, 64), (6000, 128), (8000, 256)):
        if it <= bound:
            return p_init / div
    return p_init / 512


def square_sides(n_queries: int, p_init: float, h: int, w: int) -> list[int]:
    """Each query's square side from the p-schedule."""
    return [max(1, min(h - 1, int(round(math.sqrt(p_schedule(i, n_queries, p_init) * h * w)))))
            for i in range(n_queries)]


def margin_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """z_y - max_{i!=y} z_i; negative => misclassified."""
    labels = labels.long()
    masked = logits.scatter(-1, labels[:, None], float("-inf"))
    return take_class(logits, labels) - masked.amax(-1)


def make_square(
    entry_apply: Callable,
    model_cfg,
    cfg: SquareConfig,
    *,
    normalize: Normalizer = IMAGENET,
) -> Callable:
    """``run(params, images, labels, generator=None) -> x_adv``.

    Draws from ``generator`` (default: seed 0 on the images' device): the
    stripes U(-1, 1) of shape (B, 1, W, C), then per query the window's row
    and column (B, 1, 1) and the sign draws U(-1, 1) of shape (B, 1, 1, C).
    ``run.with_draws(params, images, labels, stripes, query_draws)`` takes
    them instead: ``stripes`` and ``query_draws(i, side) -> (pos_y, pos_x,
    delta)`` for query ``i``.

    On a model built under a mesh each draw is over the global batch and a
    rank keeps its rows. The early exit stays per rank and holds no
    collective: a rank whose rows are all adversarial stops, which changes
    none of its rows (an adversarial example is never updated), and the
    ranks of one model group hold the same rows, see the same margins and
    stop together, so no rank waits on a tensor-parallel all-reduce that
    another skipped."""
    apply_fn = partial(entry_apply, model_cfg)

    def margins(params, x, labels):
        return margin_loss(apply_fn(params, normalize(x)).float(), labels)

    def with_draws(params, images, labels, stripes, query_draws):
        images = to_unit_floats(images)
        b, h, w, c = images.shape
        sides = square_sides(cfg.n_queries, cfg.p_init, h, w)
        yy = torch.arange(h, device=images.device)[None, :, None]
        xx = torch.arange(w, device=images.device)[None, None, :]
        chunk = max(1, min(cfg.exit_check_every, cfg.n_queries))
        with frozen(params), torch.no_grad():
            x = linf_project(images + cfg.eps * torch.sign(stripes), images, cfg.eps)
            f = margins(params, x, labels)
            for i0 in range(0, cfg.n_queries, chunk):
                if not bool((f > 0).any()):  # the one host sync per chunk
                    break
                for i in range(i0, min(i0 + chunk, cfg.n_queries)):
                    s = sides[i]
                    pos_y, pos_x, delta = query_draws(i, s)
                    window = ((yy >= pos_y) & (yy < pos_y + s)
                              & (xx >= pos_x) & (xx < pos_x + s))
                    cand = torch.where(window[..., None], images + cfg.eps * torch.sign(delta), x)
                    cand = linf_project(cand, images, cfg.eps)
                    f_cand = margins(params, cand, labels)
                    accept = (f_cand < f) & (f > 0)  # stop moving once adversarial
                    x = torch.where(accept[:, None, None, None], cand, x)
                    f = torch.where(accept, f_cand, f)
        return x

    def run(params, images, labels, generator: Optional[torch.Generator] = None):
        images = to_unit_floats(images)
        b, h, w, c = images.shape
        dev = images.device
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        total, rows = pmesh.data_rows(pmesh.mesh_of(params), b)

        def uniform(shape):
            return torch.empty((total, *shape[1:]), device=dev).uniform_(
                -1.0, 1.0, generator=generator)[rows]

        def query_draws(i, s):
            pos_y = torch.randint(0, max(h - s, 1), (total, 1, 1), generator=generator, device=dev)
            pos_x = torch.randint(0, max(w - s, 1), (total, 1, 1), generator=generator, device=dev)
            return pos_y[rows], pos_x[rows], uniform((b, 1, 1, c))

        return with_draws(params, images, labels, uniform((b, 1, w, c)), query_draws)

    run.with_draws = with_draws
    return run
