"""White-box gradient attacks: FGSM and PGD.

Counterpart of the JAX package's ``attacks/whitebox.py``, same semantics:

* FGSM: one signed-gradient step of size eps from the clean image, clamped
  to [0,1].
* PGD: optional uniform random start in the eps-ball, then ``steps``
  iterations of ``x += alpha * sign(grad)``, each projected onto the Linf
  ball around the clean image intersected with [0,1].

The gradient is taken with respect to the images only
(``torch.autograd.grad(loss, x)``) with every model parameter frozen for the
length of the attack, so no weight gradient is ever computed; the caller's
``requires_grad`` flags are restored when the attack returns or raises (the
JAX attacks are pure functions of ``params``). Frozen, not merely left out
of ``autograd.grad``: a kernel's ``autograd.Function`` decides at forward
time from ``requires_grad`` whether its backward recomputes the parameter
gradients. ``sign(0) = 0``. The random start draws
from a ``torch.Generator`` on the images' device; on a model built under a
mesh (``parallel.mesh``) it is the draw over the global batch, of which this
rank keeps its rows, so a sharded run is the single-process run. A caller
that holds the draw itself (another framework's, in a parity test) passes it
as ``noise`` instead.

On the card, each step of an attack that :func:`make_pgd` built is one
CUDA-graph replay (:class:`StepGraphs`): the graph holds the model's forward
on the normalized image, the summed cross-entropy and their gradient with
respect to that image. The state still goes through ``normalize`` eagerly,
once a step, and autograd carries the replay's gradient back through it; the
signed step and the projection stay eager too. A step is graphed only where
it can be replayed as it was captured (:func:`graphable`), and only in an
attack of two steps or more; a direct call of :func:`pgd` and FGSM stay
eager. The kernels' launch counters (the ``*_LAUNCHES`` and ``*_CALLS`` of
:data:`COUNTED`) read as they would eagerly: what a capture counted is taken
back, and each replay adds it once. ``GRAPH_CAPTURES``, ``GRAPH_REPLAYS``
and ``EAGER_STEPS`` count captures, replayed steps and the gradient steps
run eagerly (a graph's warm-up steps among them).

While a profiler records, each stage opens its span
(``utils.observability.span``): PGD's random start (``attack.start``), each
iteration (``attack.step``), within it the model's forward and loss
(``attack.forward``, FGSM's too), the input gradient (``attack.backward``)
and the signed step with its projection (``attack.update``). A graphed step
opens ``attack.replay`` in place of the forward and the backward: the
normalization, the copy into the graph, the replay and the chain back
through the normalization.
"""

from __future__ import annotations

import collections
import weakref
from functools import partial
from typing import Callable, Optional

import torch

from ..kernels import attention, attn_block, dwconv, layer_norm, mlp, window_attention
from ..ops.nn import LoRADropout
from ..parallel import mesh as pmesh
from ..utils.observability import span
from .common import IMAGENET, Normalizer, frozen, linf_project, sum_cross_entropy, to_unit_floats

GRAPH_CAPTURES = 0  # CUDA graphs of a PGD step captured
GRAPH_REPLAYS = 0  # gradient steps run as a graph replay
EAGER_STEPS = 0  # gradient steps run eagerly, a graph's warm-up steps among them

WARMUP_STEPS = 3  # a new key's eager steps on a side stream before its capture
MAX_GRAPHS = 2  # graphs an attack keeps, the least recently used dropped first
COUNTED = (attention, attn_block, dwconv, layer_norm, mlp, window_attention)  # modules with launch counters


def launch_counts() -> dict:
    """``{(module, name): count}`` of the kernels' launch and call counters."""
    return {(m, k): v for m in COUNTED for k, v in vars(m).items()
            if k.isupper() and k.endswith(("_LAUNCHES", "_CALLS")) and isinstance(v, int)}


def add_counts(counts: dict, times: int) -> None:
    """Add ``times`` times ``counts`` (keyed as :func:`launch_counts`) to the counters."""
    for (m, k), v in counts.items():
        setattr(m, k, getattr(m, k) + times * v)


def graphable(params, device) -> bool:
    """Whether a step through the module ``params`` on ``device`` can be a
    replay of its capture: a CUDA device with no capture under way, no mesh
    axis of more than one rank (a collective each step), and no LoRA dropout
    stream live (a dense in training mode with its dropout leaves draws a new
    mask each step)."""
    if torch.device(device).type != "cuda" or not isinstance(params, torch.nn.Module):
        return False
    mesh = pmesh.mesh_of(params)
    if any(pmesh.axis_size(mesh, a) > 1 for a in (pmesh.DATA_AXIS, pmesh.MODEL_AXIS)):
        return False
    if any(m.training and isinstance(getattr(m, "dropout", None), LoRADropout)
           for m in params.modules()):
        return False
    return not torch.cuda.is_current_stream_capturing()


_SIDE_STREAMS: dict = {}  # {device: the side stream of every warm-up step on it}


def side_stream(device) -> torch.cuda.Stream:
    """The one side stream of the graphs' warm-up steps on ``device``, made
    on first use: cuBLAS keeps a workspace for each stream it has run on
    until the process ends, so a new stream for each graph would keep its
    workspaces after the attack that made them was freed."""
    device = torch.device(device)
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def weights_key(params) -> tuple:
    """The module and where its tensors live: a replaced parameter or buffer
    gives another key, so another graph."""
    return (id(params), params.training, *(t.data_ptr() for t in params.parameters()),
            *(t.data_ptr() for t in params.buffers()))


class _Graph:
    """One key's graph: its static input, labels and output, the side stream
    of its warm-up steps (:func:`side_stream`), and the launch counts of one
    replay."""

    def __init__(self, params, xn: torch.Tensor, labels: torch.Tensor):
        self.model = weakref.ref(params)
        self.x = torch.empty(xn.shape, dtype=xn.dtype, device=xn.device, requires_grad=True)
        self.labels = torch.empty_like(labels)
        self.side = side_stream(xn.device)
        self.warm = 0  # eager warm-up steps run
        self.graph = self.out = None
        self.counts: dict = {}


class StepGraphs:
    """The CUDA graphs of one attack's gradient step, keyed by the shapes and
    dtypes of the normalized images and of the labels, their device, and
    :func:`weights_key`. A new key's first ``WARMUP_STEPS`` steps run eagerly
    on a side stream (as real steps of the attack), the next is captured
    (PyTorch's whole-network recipe) and replayed, and so is every later step
    of that key. Up to ``MAX_GRAPHS`` graphs are kept, in one memory pool."""

    def __init__(self):
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.pool = None

    def grad(self, apply_fn: Callable, params, weights: tuple, xn: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        """The summed cross-entropy's gradient with respect to the normalized
        images ``xn``: after the capture, the graph's output tensor, which
        the next replay overwrites."""
        global EAGER_STEPS, GRAPH_REPLAYS
        key = (tuple(xn.shape), xn.dtype, tuple(labels.shape), labels.dtype, xn.device, weights)
        g = self.graphs.get(key)
        if g is None or g.model() is not params:
            g = self.graphs[key] = _Graph(params, xn, labels)
            while len(self.graphs) > MAX_GRAPHS:
                self.graphs.popitem(last=False)
        self.graphs.move_to_end(key)
        with torch.no_grad():
            g.x.copy_(xn)
            g.labels.copy_(labels)
        if g.graph is None and g.warm < WARMUP_STEPS:
            g.warm += 1
            EAGER_STEPS += 1
            return self._warm_up(g, apply_fn, params)
        if g.graph is None:
            self._capture(g, apply_fn, params)
        g.graph.replay()
        add_counts(g.counts, 1)
        GRAPH_REPLAYS += 1
        return g.out

    @staticmethod
    def _body(g: _Graph, apply_fn: Callable, params) -> torch.Tensor:
        with torch.enable_grad():
            loss = sum_cross_entropy(apply_fn(params, g.x), g.labels)
            (grad,) = torch.autograd.grad(loss, g.x)
        return grad

    def _warm_up(self, g: _Graph, apply_fn: Callable, params) -> torch.Tensor:
        main = torch.cuda.current_stream(g.x.device)
        g.side.wait_stream(main)
        with torch.cuda.stream(g.side):
            out = self._body(g, apply_fn, params)
        main.wait_stream(g.side)
        return out

    def _capture(self, g: _Graph, apply_fn: Callable, params) -> None:
        global GRAPH_CAPTURES
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            g.out = self._body(g, apply_fn, params)
        g.counts = {k: v - before.get(k, 0) for k, v in launch_counts().items()
                    if v != before.get(k, 0)}
        add_counts(g.counts, -1)  # nothing ran: each replay adds them
        g.graph = graph
        GRAPH_CAPTURES += 1


def _loss_grad(apply_fn: Callable, normalize: Normalizer):
    graphs = getattr(apply_fn, "graphs", None)  # make_pgd's StepGraphs, where it set them
    weights: dict = {}  # {id(params): its weights_key, or None where the step stays eager}

    def grad(x: torch.Tensor, params, labels: torch.Tensor) -> torch.Tensor:
        global EAGER_STEPS
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            if graphs is not None and id(params) not in weights:
                weights[id(params)] = (weights_key(params) if graphable(params, x.device)
                                       else None)
            if graphs is not None and weights[id(params)] is not None:
                with span("attack.replay"):
                    xn = normalize(x)
                    gn = graphs.grad(apply_fn, params, weights[id(params)], xn.detach(), labels)
                    # the vector-Jacobian product gn·d(xn)/dx as the gradient of <xn, gn>
                    # (exactly gn reaches xn): autograd.grad's grad_outputs would import
                    # sympy on first use, seconds of set-up
                    (g,) = torch.autograd.grad((xn * gn).sum(), x)
                return g
            EAGER_STEPS += 1
            with span("attack.forward"):
                loss = sum_cross_entropy(apply_fn(params, normalize(x)), labels)
            with span("attack.backward"):
                (g,) = torch.autograd.grad(loss, x)
        return g

    return grad


@torch.no_grad()
def fgsm(apply_fn: Callable, params, images: torch.Tensor, labels: torch.Tensor, *,
         eps: float, normalize: Normalizer = IMAGENET) -> torch.Tensor:
    """One signed-gradient ascent step; output in [0,1]."""
    g = _loss_grad(apply_fn, normalize)(images, params, labels)
    return torch.clamp(images + eps * torch.sign(g), 0.0, 1.0)


@torch.no_grad()
def pgd(apply_fn: Callable, params, images: torch.Tensor, labels: torch.Tensor, *,
        eps: float, alpha: float, steps: int, random_start: bool = True,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        normalize: Normalizer = IMAGENET) -> torch.Tensor:
    """Projected gradient descent over the whole step budget. ``noise``:
    the random start's U(-eps, eps) draw for these rows (the images' shape),
    in place of a draw from ``generator``."""
    grad_fn = _loss_grad(apply_fn, normalize)
    x = images
    if random_start:
        with span("attack.start"):
            if noise is None:
                if generator is None:
                    generator = torch.Generator(images.device).manual_seed(0)
                total, rows = pmesh.data_rows(pmesh.mesh_of(params), images.shape[0])
                noise = torch.empty((total, *images.shape[1:]), device=images.device).uniform_(
                    -eps, eps, generator=generator)[rows]
            x = linf_project(images + noise, images, eps)
    for _ in range(steps):
        with span("attack.step"):
            g = grad_fn(x, params, labels)
            with span("attack.update"):
                x = linf_project(x + alpha * torch.sign(g), images, eps)
    return x


def make_fgsm(entry_apply: Callable, cfg, *, eps: float,
              normalize: Normalizer = IMAGENET) -> Callable:
    """``(params, images, labels) -> adv`` FGSM; images uint8 or [0,1]."""
    apply_fn = partial(entry_apply, cfg)

    def run(params, images, labels):
        with frozen(params):
            return fgsm(apply_fn, params, to_unit_floats(images), labels, eps=eps,
                        normalize=normalize)

    return run


def make_pgd(entry_apply: Callable, cfg, *, eps: float, alpha: float, steps: int,
             random_start: bool = True, normalize: Normalizer = IMAGENET) -> Callable:
    """``(params, images, labels, generator, noise=None) -> adv`` PGD; images
    uint8 or [0,1]; ``noise``: the random start's draw (see :func:`pgd`).
    With two steps or more its steps are graphed where :func:`graphable`
    allows: the :class:`StepGraphs` ride on the ``apply_fn`` it hands
    :func:`pgd`, which hands it to :func:`_loss_grad`, so they live and die
    with the returned function."""
    apply_fn = partial(entry_apply, cfg)
    if steps >= 2:
        apply_fn.graphs = StepGraphs()

    def run(params, images, labels, generator=None, noise=None):
        with frozen(params):
            return pgd(apply_fn, params, to_unit_floats(images), labels, eps=eps,
                       alpha=alpha, steps=steps, random_start=random_start,
                       generator=generator, noise=noise, normalize=normalize)

    return run
