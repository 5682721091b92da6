"""Load the JAX package's variables into the port's modules.

``variables`` is the ``{"params": ..., "constants": ...}`` tree of the flax
model (``PSGTr(ResNet, PairNetHead)``) with numpy leaves. The port's
``state_dict()`` keys are the reference checkpoint's keys, so this is the
exact inverse of the JAX package's checkpoint converter
(``pairnet_tpu/utils/torch_convert.py::convert_pairnet_checkpoint``):

* torch Linear weight (out, in)   <- flax Dense kernel (in, out)
* torch Conv2d (O, I, kh, kw)     <- flax Conv kernel (kh, kw, I, O)
* LayerNorm/GroupNorm weight      <- flax scale
* packed in_proj (3C, C) / (3C,)  <- q_proj/k_proj/v_proj kernels and biases
* FrozenBatchNorm buffers         <- the ``constants`` collection
* nn.Embedding weight             <- the flax parameter itself

Every port parameter and buffer must be filled and every JAX leaf used;
anything else raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from pairnet_torch.models.layers import FrozenBatchNorm, MultiheadAttention

# torch module name -> flax module path, applied in order on the dotted name
_E = r"(?=\.|$)"  # end of a name component
_RULES = [
    (r"^backbone\.layer(\d+)\.(\d+)\.downsample\.0" + _E, r"backbone.layer\1_\2.downsample_conv"),
    (r"^backbone\.layer(\d+)\.(\d+)\.downsample\.1" + _E, r"backbone.layer\1_\2.downsample_bn"),
    (r"^backbone\.layer(\d+)\.(\d+)" + _E, r"backbone.layer\1_\2"),
    (r"\.(input|lateral|output)_convs\.(\d+)\.conv" + _E, r".\1_conv_\2"),
    (r"\.(input|lateral|output)_convs\.(\d+)\.gn" + _E, r".\1_gn_\2"),
    (r"\.encoder\.layers\.(\d+)\.attentions\.0" + _E, r".encoder_layer_\1.attn"),
    (r"\.encoder\.layers\.(\d+)" + _E, r".encoder_layer_\1"),
    (r"^bbox_head\.transformer_decoder\.layers\.(\d+)" + _E,
     r"bbox_head.transformer_decoder.layer_\1"),
    (r"^bbox_head\.relation_decoder\.layers\.(\d+)" + _E, r"bbox_head.relation_layer_\1"),
    (r"\.attentions\.0\.attn" + _E, ".cross_attn"),
    (r"\.attentions\.1\.attn" + _E, ".self_attn"),
    (r"\.norms\.(\d)" + _E, lambda m: f".norm{int(m.group(1)) + 1}"),
    (r"\.ffns\.0\.layers\.0\.0" + _E, ".ffn.fc1"),
    (r"\.ffns\.0\.layers\.1" + _E, ".ffn.fc2"),
    (r"^bbox_head\.(query_feat|query_embed|level_embed|cls_embed|mask_embed)" + _E,
     r"bbox_head.transformer_decoder.\1"),
    (r"(mask_embed|_query_update)\.([024])" + _E,
     lambda m: f"{m.group(1)}.layers_{int(m.group(2)) // 2}"),
    (r"\.update_importance\.conv_layers\.(\d)\.0" + _E, r".update_importance.conv\1"),
]


def flax_path(module_name: str) -> tuple[str, ...]:
    """The flax module path of the port's module ``module_name``."""
    name = module_name
    for pattern, repl in _RULES:
        name = re.sub(pattern, repl, name)
    return tuple(name.split("."))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_leaves(module: nn.Module):
    """(port tensor name, collection, flax leaf name, numpy -> torch layout)
    for the tensors a module owns directly."""
    T = lambda a: a.T  # noqa: E731
    if isinstance(module, nn.Linear):
        yield "weight", "params", "kernel", T
        if module.bias is not None:
            yield "bias", "params", "bias", None
    elif isinstance(module, nn.Conv2d):
        yield "weight", "params", "kernel", lambda a: a.transpose(3, 2, 0, 1)
        if module.bias is not None:
            yield "bias", "params", "bias", None
    elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
        yield "weight", "params", "scale", None
        yield "bias", "params", "bias", None
    elif isinstance(module, nn.Embedding):
        yield "weight", "params", None, None
    elif isinstance(module, FrozenBatchNorm):
        for n in ("weight", "bias", "running_mean", "running_var"):
            yield n, "constants", n, None


def load_jax_variables(model: nn.Module, variables: dict, prefix: str = "") -> nn.Module:
    """Copy the flax ``variables`` into ``model`` in place and return it.

    ``prefix`` is the dotted name of ``model`` inside a full Pair-Net
    (e.g. ``"bbox_head.pixel_decoder.encoder.layers.0."``) when ``model``
    is one of its submodules; ``variables`` is then still rooted at the
    full model's tree.
    """
    flat = {
        (col,) + path: np.asarray(v)
        for col in ("params", "constants")
        for path, v in _leaves(variables.get(col, {}))
    }
    used = set()
    filled = set()

    def take(key):
        if key not in flat:
            raise KeyError(f"JAX variables have no leaf {'/'.join(key)}")
        used.add(key)
        return flat[key]

    with torch.no_grad():
        for mname, module in model.named_modules():
            full = (prefix + mname).rstrip(".")
            base = flax_path(full)
            dst_prefix = f"{mname}." if mname else ""
            if isinstance(module, MultiheadAttention):
                qkv = [take(("params",) + base + (p, "kernel")).T for p in ("q_proj", "k_proj", "v_proj")]
                bias = [take(("params",) + base + (p, "bias")) for p in ("q_proj", "k_proj", "v_proj")]
                module.in_proj_weight.copy_(torch.from_numpy(np.concatenate(qkv)))
                module.in_proj_bias.copy_(torch.from_numpy(np.concatenate(bias)))
                filled.update({dst_prefix + "in_proj_weight", dst_prefix + "in_proj_bias"})
                continue
            for tname, col, leaf, fn in _module_leaves(module):
                arr = take((col,) + base + ((leaf,) if leaf else ()))
                arr = np.ascontiguousarray(fn(arr) if fn else arr)
                dst = getattr(module, tname)
                if tuple(dst.shape) != arr.shape:
                    raise ValueError(f"{dst_prefix}{tname}: port {tuple(dst.shape)} vs JAX {arr.shape}")
                dst.copy_(torch.from_numpy(arr))
                filled.add(dst_prefix + tname)

    missing = set(model.state_dict()) - filled
    if missing:
        raise KeyError(f"port tensors without a JAX leaf: {sorted(missing)}")
    scope = flax_path(prefix.rstrip(".")) if prefix else ()
    unused = [k for k in flat if k[1 : 1 + len(scope)] == scope and k not in used]
    if unused:
        raise KeyError(f"JAX leaves not loaded: {sorted('/'.join(k) for k in unused)}")
    return model
