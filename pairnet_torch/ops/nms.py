"""Fixed-shape greedy NMS, batched over images.

Counterpart of ``pairnet_tpu/ops/nms.py``: sort by score (stable, invalid
entries at ``-inf``, as ``jnp.argsort`` of the negated scores), then the
greedy sweep over the sorted boxes: a valid box that no earlier kept box
suppressed is kept and suppresses every later box of IoU > threshold
(``ops/boxes.py::box_iou``). ``batched_nms`` is class-aware through the
class-offset trick, ``multiclass_nms`` keeps every (box, class) pair above
a score threshold.

The sweep over the sorted boxes is :func:`nms_sorted`: on CUDA tensors it
launches ``csrc/nms.cu`` (one CTA an image, ``nms_sorted.launches``) or
raises, for more boxes than the kernel holds or a failed build or launch;
CPU tensors take :func:`nms_sorted_plain`, the same sweep as a loop of
torch ops over the sorted IoU matrix (it runs on any device).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pairnet_torch.ops import _build
from pairnet_torch.ops.boxes import box_iou

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = _build.load("nms")
    lib.nms_sorted.argtypes = [_P, _P, _P, _I, _I, ctypes.c_float, _P]
    lib.nms_sorted.restype = ctypes.c_int
    lib.nms_max_boxes.argtypes = []
    lib.nms_max_boxes.restype = ctypes.c_int
    return lib


def nms_sorted_plain(boxes, valid, iou_threshold: float):
    """Keep mask (B, N) of boxes (B, N, 4) sorted by score with ``valid``
    (B, N): the greedy sweep as torch ops (N steps, no host sync)."""
    B, N, _ = boxes.shape
    over = box_iou(boxes, boxes)[0] > iou_threshold  # (B, N, N)
    keep = torch.zeros((B, N), dtype=torch.bool, device=boxes.device)
    suppressed = torch.zeros_like(keep)
    for i in range(N):
        kept = valid[:, i] & ~suppressed[:, i]
        keep[:, i] = kept
        suppressed |= kept[:, None] & over[:, i]
    return keep


def nms_sorted_cuda(boxes, valid, iou_threshold: float):
    """``csrc/nms.cu`` on boxes (B, N, 4) f32 sorted by score, ``valid``
    (B, N): the keep mask (B, N) in the sorted order."""
    B, N, _ = boxes.shape
    if N > _lib().nms_max_boxes():
        raise ValueError(f"nms: {N} boxes an image, the kernel holds at most "
                         f"{_lib().nms_max_boxes()}")
    boxes = boxes.float().contiguous()
    valid = valid.to(torch.uint8).contiguous()
    keep = torch.empty((B, N), dtype=torch.uint8, device=boxes.device)
    if B and N:
        with torch.cuda.device(boxes.device):
            stream = torch.cuda.current_stream(boxes.device).cuda_stream
            status = _lib().nms_sorted(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), B, N,
                                       float(iou_threshold), stream)
        _build.check(status, "nms")
        nms_sorted.launches += 1
    return keep.bool()


def nms_sorted(boxes, valid, iou_threshold: float):
    """The kernel for CUDA tensors, the plain sweep for CPU tensors."""
    if boxes.device.type == "cpu":
        return nms_sorted_plain(boxes, valid, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms: unsupported device {boxes.device}")
    return nms_sorted_cuda(boxes, valid, iou_threshold)


nms_sorted.launches = 0


def score_order(scores, valid):
    """The stable descending order of ``scores`` with invalid entries last
    (``jnp.argsort(-where(valid, scores, -inf))``)."""
    return torch.argsort(-torch.where(valid, scores, -torch.inf), dim=-1, stable=True)


def nms(boxes, scores, iou_threshold: float = 0.5, valid=None):
    """Greedy NMS. boxes (..., N, 4) xyxy, scores (..., N), one leading
    batch dimension at most. Returns the bool keep mask in the input order;
    ``valid`` masks out padded entries."""
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
        valid = None if valid is None else valid[None]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    order = score_order(scores, valid)
    keep_sorted = nms_sorted(torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
                             torch.gather(valid, 1, order), iou_threshold)
    keep = torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)
    return keep[0] if single else keep


def batched_nms(boxes, scores, labels, iou_threshold: float = 0.5, valid=None):
    """Class-aware NMS by the class-offset trick (torchvision semantics),
    in f32 as JAX computes it: each image's boxes move by
    ``label * (2 * (max |box| + 1))``."""
    max_coord = boxes.abs().amax(dim=(-2, -1), keepdim=True) + 1.0  # (..., 1, 1)
    offsets = labels.to(boxes.dtype)[..., None] * (2.0 * max_coord)
    return nms(boxes + offsets, scores, iou_threshold, valid)


def multiclass_nms(boxes, scores, score_thr: float, iou_threshold: float, max_per_img: int,
                   valid=None):
    """Multi-class NMS keeping the full score distributions, for one image:
    boxes (N, 4), scores (N, C) without the background column. Every (box,
    class) pair above ``score_thr`` competes; the top ``max_per_img`` by
    score are returned as (boxes (K, 4), scores (K,), labels (K,), dists
    (K, C), keep (K,)); padded slots have keep False."""
    N, C = scores.shape
    dev = scores.device
    if valid is None:
        valid = torch.ones((N,), dtype=torch.bool, device=dev)
    flat_scores = scores.reshape(-1)
    flat_labels = torch.arange(C, dtype=torch.int32, device=dev).repeat(N)
    flat_boxes = boxes.repeat_interleave(C, dim=0)
    flat_valid = valid.repeat_interleave(C) & (flat_scores > score_thr)
    box_ids = torch.arange(N, device=dev).repeat_interleave(C)
    keep = batched_nms(flat_boxes, flat_scores, flat_labels, iou_threshold, flat_valid)
    ranked = score_order(flat_scores, keep)[:max_per_img]
    kmask = keep[ranked]
    return (flat_boxes[ranked], torch.where(kmask, flat_scores[ranked], 0.0),
            flat_labels[ranked], scores[box_ids[ranked]], kmask)
