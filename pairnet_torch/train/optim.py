"""Optimizer assembly: AdamW with paramwise lr multipliers, step LR, clip.

Counterpart of ``pairnet_tpu/train/optim.py``: AdamW(lr 1e-4, wd 1e-4,
betas (0.9, 0.999), eps 1e-8), the reference's ``paramwise_cfg`` multipliers
(0.1 for backbone / transformer_decoder / pixel_decoder, 0.0 for the frozen
stem and layer1), no decay on LayerNorm/GroupNorm, global-norm clip 0.1 and
a step LR (gamma 0.5 at epochs 5 and 10).

The multipliers are matched by substring on each parameter's **flax path**
(:func:`pairnet_torch.utils.from_jax.flax_path`), not on its torch name:
``query_feat``, ``query_embed``, ``level_embed``, ``cls_embed`` and
``mask_embed`` sit on the head in the port (reference checkpoint naming)
but under ``bbox_head/transformer_decoder/`` in flax, so they train at 0.1x
as in the JAX package. A multiplier scales the Adam step and the decoupled
decay alike: each (multiplier, decay) pair is one param group with lr
``base_lr * mult``. The frozen stem keeps ``requires_grad`` and takes part
in the clip's norm, as in JAX; its multiplier 0.0 keeps it in place.
"""

from __future__ import annotations

import bisect
from typing import Mapping, Sequence

import torch
from torch import nn

from pairnet_torch.utils.from_jax import tensor_leaves

GRAD_CLIP = 0.1  # max global L2 norm of the gradients (reference config)
DEFAULT_LR_KEYS = {
    "backbone/conv1": 0.0,
    "backbone/bn1": 0.0,
    "backbone/layer1": 0.0,
    "backbone": 0.1,
    "transformer_decoder": 0.1,
    "pixel_decoder": 0.1,
}


def _param_paths(model: nn.Module) -> dict[str, list[tuple[str, ...]]]:
    """Parameter name -> the flax leaf paths it is made of."""
    params = dict(model.named_parameters())
    return {name: paths for name, col, paths, _ in tensor_leaves(model)
            if col == "params" and name in params}


def lr_mult_tree(model: nn.Module, custom_keys: Mapping[str, float]) -> dict[str, float]:
    """Parameter name -> lr multiplier: the first key that is a substring
    of the "/"-joined flax path wins, else 1.0."""
    out = {}
    for name, paths in _param_paths(model).items():
        mults = set()
        for path in paths:
            p = "/".join(path)
            mults.add(next((m for key, m in custom_keys.items() if key in p), 1.0))
        if len(mults) != 1:
            raise ValueError(f"{name}: its flax leaves take different multipliers {mults}")
        out[name] = mults.pop()
    return out


def norm_free_decay_mask(model: nn.Module) -> dict[str, bool]:
    """Parameter name -> whether weight decay applies: False for the weight
    and bias of LayerNorm/GroupNorm (flax norm modules), True elsewhere,
    Dense biases included (mmcv norm_decay_mult=0)."""
    norms = {f"{m}.{t}" for m, mod in model.named_modules()
             if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)) for t in ("weight", "bias")}
    return {name: name not in norms for name, _ in model.named_parameters()}


def step_lr_schedule(base_lr: float, steps_per_epoch: int,
                     decay_epochs: Sequence[int] = (5, 10), gamma: float = 0.5):
    """step -> lr: ``base_lr`` times ``gamma`` for every boundary
    ``epoch * steps_per_epoch`` that the step has reached (optax
    piecewise_constant_schedule)."""
    bounds = sorted(int(e * steps_per_epoch) for e in decay_epochs)

    def schedule(step: int) -> float:
        return base_lr * gamma ** bisect.bisect_right(bounds, int(step))

    return schedule


def build_optimizer(model: nn.Module, base_lr: float = 1e-4, weight_decay: float = 1e-4,
                    custom_lr_keys: Mapping[str, float] | None = None,
                    betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8):
    """AdamW over ``model``'s parameters, one group per (multiplier, decay)
    pair. Each group records its ``lr_mult``; :func:`set_lr` sets the
    groups' lr from a scheduled base lr."""
    mults = lr_mult_tree(model, DEFAULT_LR_KEYS if custom_lr_keys is None else custom_lr_keys)
    decay = norm_free_decay_mask(model)
    groups: dict[tuple[float, bool], list] = {}
    for name, p in model.named_parameters():
        groups.setdefault((mults[name], decay[name]), []).append(p)
    param_groups = [
        {"params": ps, "lr": base_lr * m, "lr_mult": m,
         "weight_decay": weight_decay if d else 0.0}
        for (m, d), ps in groups.items()
    ]
    return torch.optim.AdamW(param_groups, lr=base_lr, betas=betas, eps=eps,
                             weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, base_lr: float) -> None:
    """Set every group's lr to ``base_lr`` times its multiplier."""
    for group in optimizer.param_groups:
        group["lr"] = base_lr * group["lr_mult"]


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's clip_by_global_norm, in place: ``g * min(1, max_norm / |g|)``
    over all gradients (not ``clip_grad_norm_``'s ``max_norm / (|g| +
    1e-6)``). Returns the pre-clip global norm."""
    norms = torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    norm = torch.linalg.vector_norm(norms)
    scale = torch.clamp_max(max_norm / norm, 1.0)
    torch._foreach_mul_(list(grads), scale)
    return norm
