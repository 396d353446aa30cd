"""The two tensor-parallel collectives, as ``autograd.Function``s over the
mesh's model group.

* :func:`copy_to_model`: forward identity, backward all-reduce. Every
  replicated tensor that enters a computation split over the model axis
  goes through it (a block's normalized input, and a fused kernel's raw
  input and LayerNorm parameters), so its gradient is the sum of the ranks'
  partial gradients.
* :func:`reduce_from_model`: forward all-reduce, backward identity. It adds
  up the row-split projection's partial outputs; every rank then holds the
  same tensor and the same cotangent.

Both sum in float32 and return the input's dtype. Every rank of a model
group computes the same loss from the same rows, so each rank's gradient of
that loss is already the whole gradient: a backward that all-reduced it
again (``torch.distributed.nn.functional.all_reduce``'s does) would count
it once per rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _sum_f32(t: torch.Tensor, group) -> torch.Tensor:
    acc = t.to(torch.float32, copy=True, memory_format=torch.contiguous_format)
    dist.all_reduce(acc, group=group)
    return acc.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)
