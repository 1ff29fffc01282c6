"""Collectives over a mesh axis that autograd can see.

``Mesh.all_reduce`` runs ``torch.distributed`` on a clone (on the CPU) or
through a pinned host buffer (a CUDA tensor under gloo), so the graph it
leaves depends on the route.  These two ``torch.autograd.Function``s
record one node whichever route it takes, with the backward the
reference's ``psum`` inside ``shard_map`` gets for a region whose inputs
are replicated over the axis and whose output is replicated downstream
(Megatron's g and f operators):

* ``reduce_from(x, mesh, axis)``: the sum of ``x`` over ``axis``.  Its
  backward is the identity: every rank of the axis computes the same
  loss from the sum, so each partial's gradient is the sum's (a summing
  backward would scale it by the axis size).
* ``copy_to(x, mesh, axis)``: ``x`` itself.  Its backward sums the
  gradient over ``axis``: each rank differentiates only its own share of
  what ``x`` feeds (its slice of the experts, say), and ``x``'s gradient
  is the sum of the shares.

An axis of size 1 is skipped, as ``Mesh.all_reduce`` skips it.
"""
from __future__ import annotations

import torch


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axis), None, None


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis``; its backward passes the gradient
    through unchanged."""
    return _ReduceFrom.apply(x, mesh, axis)


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x``; its backward sums the gradient over ``axis``."""
    return _CopyTo.apply(x, mesh, axis)
