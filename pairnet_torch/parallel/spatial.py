"""Sequence (spatial) parallelism for the deformable encoder.

Counterpart of ``pairnet_tpu/parallel/spatial.py``. The pixel decoder's
encoder runs 6 MSDA + FFN layers over every token of three levels (22050
at 800x1344), so the token axis is the model-parallel dimension:

* each rank of a sequence group owns ``S_pad / m`` consecutive tokens
  (queries, positional encodings, reference points) of its batch rows,
  the tokens padded to a multiple of ``m`` (the padding is dropped on exit);
* inside each layer the value projection runs on the local tokens, then
  ONE all-gather of the projected (B, S/m, H, D) plane per layer
  (:func:`gather_tokens`), sliced to the S real tokens before the MSDA call:
  a query may tap anywhere;
* the offset, attention-weight and output projections, the LayerNorms and
  the FFN stay ``1/m``-sized.

The all-gather is an autograd Function: forward ``all_gather_into_tensor``,
backward ``reduce_scatter_tensor`` (every rank's queries read the whole
plane, so each rank's rows take the sum of all ranks' gradients). The exit
gather of :func:`sequence_parallel_encoder` instead hands each rank the
gradient of its own rows, because what follows it runs alike on every rank
of the group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class _GatherTokens(torch.autograd.Function):
    """(B, s, ...) local rows -> (B, m * s, ...) in rank order."""

    @staticmethod
    def forward(ctx, x, group, reduce_grad):
        ctx.group, ctx.reduce_grad = group, reduce_grad
        ctx.rank, m = dist.get_rank(group), dist.get_world_size(group)
        # the collective concatenates along dim 0: tokens first
        xt = x.transpose(0, 1).contiguous()
        out = xt.new_empty((m * xt.shape[0], *xt.shape[1:]))
        dist.all_gather_into_tensor(out, xt, group=group)
        return out.transpose(0, 1)

    @staticmethod
    def backward(ctx, g):
        gt = g.transpose(0, 1).contiguous()
        s = gt.shape[0] // dist.get_world_size(ctx.group)
        if ctx.reduce_grad:
            out = gt.new_empty((s, *gt.shape[1:]))
            dist.reduce_scatter_tensor(out, gt, group=ctx.group)
        else:
            out = gt[ctx.rank * s : (ctx.rank + 1) * s]
        return out.transpose(0, 1), None, None


def gather_tokens(x: torch.Tensor, group, reduce_grad: bool = True) -> torch.Tensor:
    """All-gather the token axis (dim 1) of every rank's ``x`` over
    ``group``; the gradient of the local rows is summed over the ranks
    (``reduce_grad``) or the rank's own rows of the output's gradient."""
    return _GatherTokens.apply(x, group, reduce_grad)


def sequence_parallel_encoder(layers, tokens, pos, reference_points, spatial_shapes, group):
    """Run ``layers`` (``DeformableEncoderLayer``\\ s built with
    ``seq_group=group``) with the token axis split over ``group``.

    Every rank of the group passes the same tokens (B, S, C), pos (B, S, C)
    and reference points (B, S, L, 2) of its batch rows; each computes its
    ``S_pad / m`` tokens and gets back all S, equal to the sequential stack."""
    for layer in layers:
        if layer.attentions[0].seq_group is not group:
            raise ValueError("each layer must be built with seq_group=group")
    B, S, _ = tokens.shape
    rank, m = dist.get_rank(group), dist.get_world_size(group)
    S_pad = _round_up(S, m)
    s = S_pad // m
    if S_pad != S:
        # padded queries compute values that are dropped on exit; they
        # read the plane but no real query reads them (the plane is sliced
        # to its S real tokens before every MSDA call)
        pad = S_pad - S
        tokens = torch.nn.functional.pad(tokens, (0, 0, 0, pad))
        pos = torch.nn.functional.pad(pos, (0, 0, 0, pad))
        reference_points = torch.nn.functional.pad(reference_points, (0, 0, 0, 0, 0, pad))
    rows = slice(rank * s, (rank + 1) * s)
    x, pos, ref = tokens[:, rows], pos[:, rows], reference_points[:, rows]
    for layer in layers:
        x = layer(x, pos, ref, spatial_shapes)
    return gather_tokens(x, group, reduce_grad=False)[:, :S]
