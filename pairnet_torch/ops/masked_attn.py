"""Masked flash cross-attention: the wrapper of ``csrc/masked_attn.cu`` and
its plain version.

Replaces ``pairnet_tpu/ops/pallas_masked_attn.py::_kernel`` (via
``masked_flash_attention``), the Mask2Former decoder's cross-attention over
a long memory with a mask shared by the heads of an image. Per (b*h) plane:
f32 scores q.k / sqrt(D) (the TPU kernel and the plain version scale q
before the dot; the kernel's bf16 instance scales the exact product
after it), -1e9 where the mask is set, softmax in f32, f32 output (the
caller casts it). Inference only: no backward, in JAX or here.

The JAX wrapper pads the queries to 8 and the keys to 1024-key tiles with
the padded keys masked; the kernel here takes any Lq and Lk and leaves the
keys past the end out of the softmax. On every row with a live key the two
agree (a masked key adds exp(-1e9 - max) = 0).

The kernel (see the source note) splits the keys into chunks of
:func:`chunk_keys` keys, one CTA per (image, chunk), and merges the chunks'
partial softmax states in a second pass; the wrapper allocates their f32
scratch. On CPU tensors :func:`masked_flash_attention` runs the plain
version; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from pairnet_torch.ops import _build

MASKED = -1e9  # the TPU kernel's fill of a masked score
_P = ctypes.c_void_p
_I = ctypes.c_int
_FN = {torch.float32: "masked_attn_f32", torch.bfloat16: "masked_attn_bf16"}
HEAD_DIMS = (8, 16, 32, 64)  # the kernel's instances
KEY_TILE, MAX_CHUNK = 64, 512  # keys per staged tile; keys per CTA, at most


@functools.cache
def _lib():
    lib = _build.load("masked_attn")
    for name in _FN.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P] * 7 + [_I] * 6 + [ctypes.c_float, _P]
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def chunk_keys(B: int, Lk: int, sms: int) -> int:
    """Keys per CTA of the kernel: a multiple of ``KEY_TILE`` up to
    ``MAX_CHUNK``, small enough that the B images' chunks make about two
    CTAs per SM."""
    chunks = -(-2 * sms // B)
    per_chunk = -(-Lk // chunks)
    ck = -(-per_chunk // KEY_TILE) * KEY_TILE
    return min(MAX_CHUNK, max(KEY_TILE, ck))


def masked_flash_attention_plain(q, k, v, mask, num_heads: int):
    """Plain version of :func:`masked_flash_attention`, in the TPU kernel's
    order: ``q * (1/sqrt(D))`` in f32, an f32 product with k, the -1e9 fill,
    an f32 softmax, an f32 product with v."""
    BH, Lq, D = q.shape
    Lk = k.shape[1]
    B = BH // num_heads
    s = torch.matmul(q.float() * (1.0 / math.sqrt(D)), k.float().transpose(1, 2))
    s = s.reshape(B, num_heads, Lq, Lk).masked_fill(mask[:, None], MASKED)
    p = torch.softmax(s, dim=-1).reshape(BH, Lq, Lk)
    return torch.matmul(p, v.float())


def check_inputs(q, k, v, mask, num_heads: int):
    """Raise unless the arguments have the kernel's layout."""
    BH, Lq, D = q.shape
    if k.shape != (BH, k.shape[1], D) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if num_heads < 1 or BH % num_heads:
        raise ValueError(f"{BH} planes are not a multiple of {num_heads} heads")
    if mask.dtype != torch.bool or mask.shape != (BH // num_heads, Lq, k.shape[1]):
        raise ValueError(f"mask {mask.dtype} {tuple(mask.shape)} is not bool "
                         f"{(BH // num_heads, Lq, k.shape[1])}")
    if not (q.device == k.device == v.device == mask.device):
        raise ValueError("q, k, v and mask must be on one device")


def masked_flash_attention(q, k, v, mask, num_heads: int):
    """q (B*H, Lq, D); k, v (B*H, Lk, D), all f32 or all bf16; mask bool
    (B, Lq, Lk), True = masked out, shared by the H heads of image b.
    Returns f32 (B*H, Lq, D)."""
    check_inputs(q, k, v, mask, num_heads)
    if q.device.type == "cpu":
        return masked_flash_attention_plain(q, k, v, mask, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"masked_flash_attention: unsupported device {q.device}")
    if q.dtype not in _FN or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"masked_flash_attention: q, k, v dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype} are not all f32 or all bf16")
    BH, Lq, D = q.shape
    Lk = k.shape[1]
    if D not in HEAD_DIMS or Lq < 1 or Lk < 1:
        raise ValueError(f"masked_flash_attention: the kernel takes D in {HEAD_DIMS}, Lq >= 1 "
                         f"and Lk >= 1, not D={D}, Lq={Lq}, Lk={Lk}")
    # contiguous, and 16-byte aligned for the kernel's cp.async copies
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    mask = mask.contiguous()
    ck = chunk_keys(BH // num_heads, Lk, _sm_count(q.device))
    nc = -(-Lk // ck)
    f32 = dict(device=q.device, dtype=torch.float32)
    out = torch.empty((BH, Lq, D), **f32)
    pacc = torch.empty((nc, BH, Lq, D), **f32)  # each chunk's partial sum of p v
    pml = torch.empty((nc, BH, Lq, 2), **f32)  # each chunk's (max, sum of p)
    with torch.cuda.device(q.device):
        status = getattr(_lib(), _FN[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            pacc.data_ptr(), pml.data_ptr(), BH, num_heads, Lq, Lk, D, ck,
            1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "masked_flash_attention")
    masked_flash_attention.launches += 1
    return out


masked_flash_attention.launches = 0
