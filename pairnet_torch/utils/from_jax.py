"""Load the JAX package's variables into the port's modules.

``variables`` is the ``{"params": ..., "constants": ...}`` tree of the flax
model (``PSGTr(backbone, head)``) with numpy leaves. The port's
``state_dict()`` keys are the reference checkpoint's keys, so this is the
exact inverse of the JAX package's checkpoint converters
(``pairnet_tpu/utils/torch_convert.py``: ``convert_pairnet_checkpoint``,
``convert_psgtr_checkpoint``, ``convert_psgformer_checkpoint``,
``convert_baseline_checkpoint``, ``convert_crosshead_bbox_checkpoint``).
PSGTr2 and DETR4Seg, which have no converter, share those heads' modules
and names:

* torch Linear weight (out, in)   <- flax Dense kernel (in, out)
* torch Conv2d (O, I, kh, kw)     <- flax Conv kernel (kh, kw, I, O)
* LayerNorm/GroupNorm weight      <- flax scale
* packed in_proj (3C, C) / (3C,)  <- q_proj/k_proj/v_proj kernels and biases
* FrozenBatchNorm buffers         <- the ``constants`` collection
* nn.Embedding weight             <- the flax parameter itself
* RMSNorm weight                  <- flax ``weight``
* the box head's ``level_embeds`` <- flax ``level_embed`` (its ChannelMapper,
  the model's ``neck``, lives inside the flax head)
* Swin PatchMerging norm/reduction <- the JAX module's (ky, kx, c) rows of
  4C, permuted into mmdet's ``nn.Unfold`` order (c, ky, kx)

Every port parameter and buffer must be filled and every JAX leaf used;
anything else raises. The ``--load-from`` warm start of the train CLI
(:func:`load_pretrained`) overlays instead: a leaf the model lacks or of
another shape raises, a tensor with no leaf keeps its init.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from pairnet_torch.models.backbones.swin import PatchMerging, WindowMSA
from pairnet_torch.models.heads.pairnet_bbox_head import CrossHeadBBox, DeformableDetrTransformer
from pairnet_torch.models.layers import FrozenBatchNorm, MultiheadAttention, RMSNorm

# torch module name -> flax module path, applied in order on the dotted name
_E = r"(?=\.|$)"  # end of a name component
_SWIN_BLOCK = r"^backbone\.stage(\d+)_block(\d+)"
# the Mask2Former heads' query tables and prediction heads, which flax keeps
# on the decoder (a DETR head's own ``query_embed`` stays on the head)
_M2F_TABLES = r"^bbox_head\.(query_feat|query_embed|level_embed|cls_embed|mask_embed)" + _E
_RULES = [
    # the DETR transformer of PSGTr / PSGFormer / DETR4Seg: attentions.0 is self-attention
    (r"^bbox_head\.transformer\.encoder\.layers\.(\d+)\.attentions\.0\.attn" + _E,
     r"bbox_head.transformer.enc_\1.self_attn"),
    (r"^bbox_head\.transformer\.encoder\.layers\.(\d+)" + _E, r"bbox_head.transformer.enc_\1"),
    (r"^bbox_head\.transformer\.decoder([12]?)\.layers\.(\d+)\.attentions\.0\.attn" + _E,
     r"bbox_head.transformer.dec\1_\2.self_attn"),
    (r"^bbox_head\.transformer\.decoder([12]?)\.layers\.(\d+)\.attentions\.1\.attn" + _E,
     r"bbox_head.transformer.dec\1_\2.cross_attn"),
    (r"^bbox_head\.transformer\.decoder([12]?)\.layers\.(\d+)" + _E,
     r"bbox_head.transformer.dec\1_\2"),
    (r"^bbox_head\.transformer\.decoder\.post_norm" + _E, "bbox_head.transformer.post_norm"),
    (r"^bbox_head\.transformer\.decoder([12])\.post_norm" + _E,
     r"bbox_head.transformer.dec\1_post_norm"),
    (r"box_embed\.layers\.(\d)" + _E, r"box_embed.layers_\1"),
    (r"^backbone\.patch_embed\.projection" + _E, "backbone.patch_embed"),
    (r"^backbone\.patch_embed\.norm" + _E, "backbone.patch_norm"),
    (r"^backbone\.stages\.(\d+)\.blocks\.(\d+)" + _E, r"backbone.stage\1_block\2"),
    (r"^backbone\.stages\.(\d+)\.downsample" + _E, r"backbone.merge\1"),
    (r"^backbone\.norm(\d+)" + _E, r"backbone.out_norm\1"),
    (_SWIN_BLOCK + r"\.attn\.w_msa" + _E, r"backbone.stage\1_block\2.attn"),
    (_SWIN_BLOCK + r"\.ffn\.layers\.0\.0" + _E, r"backbone.stage\1_block\2.mlp_fc1"),
    (_SWIN_BLOCK + r"\.ffn\.layers\.1" + _E, r"backbone.stage\1_block\2.mlp_fc2"),
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
    (_M2F_TABLES, r"bbox_head.transformer_decoder.\1"),
    (r"(mask_embed|_query_update|pair_embed|rel_cls_embed)\.([024])" + _E,
     lambda m: f"{m.group(1)}.layers_{int(m.group(2)) // 2}"),
    (r"\.update_importance\.conv_layers\.(\d)\.0" + _E, r".update_importance.conv\1"),
]



def _bbox_rules(n_in: int, n_dec: int):
    """The box head's names (``convert_crosshead_bbox``) for a ChannelMapper
    of ``n_in`` input levels and ``n_dec`` decoder layers: the neck moves
    into the head, the transformer's modules onto the head, the last
    cls/reg branch is the encoder-proposal head."""
    tr = r"^bbox_head\.transformer\."
    return [
        (r"^neck\.convs\.(\d+)\.(conv|gn)" + _E, r"bbox_head.neck.\2_\1"),
        (r"^neck\.extra_convs\.(\d+)\.(conv|gn)" + _E,
         lambda m: f"bbox_head.neck.extra_{m.group(2)}_{n_in + int(m.group(1))}"),
        (tr + r"encoder\.layers\.(\d+)\.attentions\.0" + _E, r"bbox_head.enc_\1.attn"),
        (tr + r"encoder\.layers\.(\d+)" + _E, r"bbox_head.enc_\1"),
        (tr + r"decoder\.layers\.(\d+)\.attentions\.0\.attn" + _E,
         r"bbox_head.dec_\1.self_attn"),
        (tr + r"decoder\.layers\.(\d+)\.attentions\.1" + _E, r"bbox_head.dec_\1.cross_attn"),
        (tr + r"decoder\.layers\.(\d+)\.ffns\.0\.layers\.0\.0" + _E,
         r"bbox_head.dec_\1.ffn_fc1"),
        (tr + r"decoder\.layers\.(\d+)\.ffns\.0\.layers\.1" + _E, r"bbox_head.dec_\1.ffn_fc2"),
        (tr + r"decoder\.layers\.(\d+)" + _E, r"bbox_head.dec_\1"),
        (tr + r"pos_trans_fc" + _E, "bbox_head.pos_trans"),
        (r"^bbox_head\.transformer" + _E, "bbox_head"),
        (r"^bbox_head\.cls_branches\.(\d+)" + _E,
         lambda m: "bbox_head." + ("enc_cls" if int(m.group(1)) == n_dec else f"cls_{m.group(1)}")),
        (r"^bbox_head\.reg_branches\.(\d+)\.([024])" + _E,
         lambda m: "bbox_head." + ("enc_box" if int(m.group(1)) == n_dec else f"reg_{m.group(1)}")
         + f".layers_{int(m.group(2)) // 2}"),
    ]


def flax_path(module_name: str, m2f: bool = True, rules=_RULES) -> tuple[str, ...]:
    """The flax module path of the port's module ``module_name``; ``m2f``
    says that the head owns a Mask2Former decoder (its tables move there),
    ``rules`` are the renames to apply (a box head's are
    ``_bbox_rules(...) + _RULES``)."""
    name = module_name
    for pattern, repl in rules:
        if m2f or pattern is not _M2F_TABLES:
            name = re.sub(pattern, repl, name)
    return tuple(name.split("."))


def _has_m2f(model: nn.Module) -> bool:
    """Whether ``model`` holds a Mask2Former decoder (a head or a whole
    detector that does)."""
    from pairnet_torch.models.decoders.mask2former_decoder import Mask2FormerDecoder

    return any(isinstance(m, Mask2FormerDecoder) for m in model.modules())


def _bbox_geometry(model: nn.Module):
    """``(n_in, n_dec)`` of the box head ``model`` holds (its neck's input
    levels and its decoder layers), or None."""
    heads = [m for m in model.modules() if isinstance(m, CrossHeadBBox)]
    if not heads:
        return None
    neck = getattr(model, "neck", None)
    return (len(neck.convs) if neck is not None else 0,
            len(heads[0].transformer.decoder.layers))


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
    elif isinstance(module, RMSNorm):
        yield "weight", "params", "weight", None
    elif isinstance(module, DeformableDetrTransformer):
        yield "level_embeds", "params", "level_embed", None
    elif isinstance(module, FrozenBatchNorm):
        for n in ("weight", "bias", "running_mean", "running_var"):
            yield n, "constants", n, None
    elif isinstance(module, WindowMSA):
        yield "relative_position_bias_table", "params", "relative_position_bias_table", None


def merge_order(four_c: int) -> np.ndarray:
    """For each of PatchMerging's 4C features in the port's (c, ky, kx)
    order, its index in the JAX module's (ky, kx, c) order (the inverse of
    ``convert_swin``'s ``tmap``)."""
    j = np.arange(four_c)
    return (j % 4) * (four_c // 4) + j // 4


def _merge_leaves(module: PatchMerging):
    """PatchMerging's tensors with the 4C axis permuted."""
    order = merge_order(module.norm.normalized_shape[0])
    yield "norm.weight", "params", ("norm", "scale"), lambda a: a[order]
    yield "norm.bias", "params", ("norm", "bias"), lambda a: a[order]
    yield "reduction.weight", "params", ("reduction", "kernel"), lambda a: a[order].T


def tensor_leaves(model: nn.Module, prefix: str = ""):
    """For every parameter and buffer of ``model``: (port tensor name,
    collection, the flax leaf paths it is made of, numpy leaves -> torch
    layout). A packed attention in_proj is made of three leaves
    (q_proj, k_proj, v_proj); every other tensor of one."""
    T = lambda a: a.T  # noqa: E731
    merges = []  # PatchMerging names: their children's tensors are yielded with them
    m2f = _has_m2f(model)
    bbox = _bbox_geometry(model)
    rules = _bbox_rules(*bbox) + _RULES if bbox else _RULES
    for mname, module in model.named_modules():
        if any(mname.startswith(m + ".") for m in merges):
            continue
        base = flax_path((prefix + mname).rstrip("."), m2f, rules)
        dst_prefix = f"{mname}." if mname else ""
        if isinstance(module, PatchMerging):
            merges.append(mname)
            for tname, col, leaf, fn in _merge_leaves(module):
                yield (dst_prefix + tname, col, [base + leaf], lambda arrs, fn=fn: fn(arrs[0]))
            continue
        if isinstance(module, MultiheadAttention):
            for tname, leaf, fn in (("in_proj_weight", "kernel", T),
                                    ("in_proj_bias", "bias", None)):
                paths = [base + (p, leaf) for p in ("q_proj", "k_proj", "v_proj")]
                yield (dst_prefix + tname, "params", paths,
                       lambda arrs, fn=fn: np.concatenate([fn(a) if fn else a for a in arrs]))
            continue
        for tname, col, leaf, fn in _module_leaves(module):
            yield (dst_prefix + tname, col, [base + ((leaf,) if leaf else ())],
                   lambda arrs, fn=fn: fn(arrs[0]) if fn else arrs[0])


def port_arrays(model: nn.Module, trees: dict, prefix: str = "") -> dict:
    """Port tensor name -> numpy array in the port's layout, for every tensor
    whose collection is a key of ``trees`` (``{"params": ..., "constants":
    ...}`` flax trees with numpy leaves). Raises on a missing leaf and on a
    leaf of those collections, under ``prefix``, that no tensor uses."""
    flat = {(col,) + path: np.asarray(v)
            for col, tree in trees.items() for path, v in _leaves(tree)}
    used, out = set(), {}
    for name, col, paths, fn in tensor_leaves(model, prefix):
        if col not in trees:
            continue
        keys = [(col,) + p for p in paths]
        for key in keys:
            if key not in flat:
                raise KeyError(f"JAX variables have no leaf {'/'.join(key)}")
        used.update(keys)
        out[name] = np.ascontiguousarray(fn([flat[k] for k in keys]))
    scope = flax_path(prefix.rstrip(".")) if prefix else ()
    unused = [k for k in flat if k[1 : 1 + len(scope)] == scope and k not in used]
    if unused:
        raise KeyError(f"JAX leaves not loaded: {sorted('/'.join(k) for k in unused)}")
    return out


def load_jax_variables(model: nn.Module, variables: dict, prefix: str = "") -> nn.Module:
    """Copy the flax ``variables`` into ``model`` in place and return it.

    ``prefix`` is the dotted name of ``model`` inside a full Pair-Net
    (e.g. ``"bbox_head.pixel_decoder.encoder.layers.0."``) when ``model``
    is one of its submodules; ``variables`` is then still rooted at the
    full model's tree.
    """
    arrays = port_arrays(
        model, {col: variables.get(col, {}) for col in ("params", "constants")}, prefix
    )
    state = model.state_dict(keep_vars=True)
    missing = set(state) - set(arrays)
    if missing:
        raise KeyError(f"port tensors without a JAX leaf: {sorted(missing)}")
    with torch.no_grad():
        for name, arr in arrays.items():
            dst = state[name]
            if tuple(dst.shape) != arr.shape:
                raise ValueError(f"{name}: port {tuple(dst.shape)} vs JAX {arr.shape}")
            dst.copy_(torch.tensor(arr))
    return model


def unflatten(flat) -> dict:
    """A ``"/"``-joined flat mapping (an ``.npz`` of flax variables,
    ``"params/backbone/conv1/kernel"``) as a nested dict."""
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return tree


def merge_pretrained(model: nn.Module, pretrained: dict) -> nn.Module:
    """Overlay the flax variables ``pretrained`` (``{"params": ...,
    "constants": ...}``, any part of the tree) onto ``model`` in place, as
    ``pairnet_tpu.utils.torch_convert.merge_pretrained`` does on flax
    variables: a leaf that no port tensor takes raises ``KeyError``, a shape
    mismatch ``ValueError``; a tensor with no leaf keeps its init."""
    flat = {(col,) + path: np.asarray(v) for col, tree in pretrained.items()
            for path, v in _leaves(tree)}
    state = model.state_dict(keep_vars=True)
    used = set()
    with torch.no_grad():
        for name, col, paths, fn in tensor_leaves(model):
            keys = [(col,) + p for p in paths]
            present = [k in flat for k in keys]
            if not any(present):
                continue
            if not all(present):
                raise KeyError(f"{name}: only some of its leaves are given: "
                               f"{['/'.join(k) for k, ok in zip(keys, present) if ok]}")
            used.update(keys)
            arr = np.ascontiguousarray(fn([flat[k] for k in keys]))
            dst = state[name]
            if tuple(dst.shape) != arr.shape:
                raise ValueError(f"shape mismatch at {name}: {tuple(dst.shape)} vs {arr.shape}")
            dst.copy_(torch.tensor(arr))
    unknown = sorted("/".join(k) for k in flat if k not in used)
    if unknown:
        raise KeyError(f"unexpected converted keys: {unknown}")
    return model


def load_pretrained(model: nn.Module, path: str) -> nn.Module:
    """Warm-start ``model`` in place from ``path``: an ``.npz`` of
    ``"/"``-flattened flax variables (:func:`merge_pretrained`), or a port
    checkpoint ``ckpts/epoch_<n>.pt`` whose model state is overlaid with the
    same rules (unknown key or shape mismatch raises, a missing key keeps
    its init)."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return merge_pretrained(model, unflatten(dict(f)))
    if not path.endswith(".pt"):
        raise ValueError(f"load_from {path!r}: expected an .npz of flax variables or a port "
                         "checkpoint .pt")
    sd = torch.load(path, map_location="cpu", weights_only=True)["state"]["model"]
    state = model.state_dict(keep_vars=True)
    unknown = sorted(set(sd) - set(state))
    if unknown:
        raise KeyError(f"unexpected checkpoint keys: {unknown}")
    with torch.no_grad():
        for name, val in sd.items():
            if state[name].shape != val.shape:
                raise ValueError(f"shape mismatch at {name}: {tuple(state[name].shape)} vs "
                                 f"{tuple(val.shape)}")
            state[name].copy_(val)
    return model


def _numpy_tree(tree):
    """A mapping tree (dict, FrozenDict) as nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _adam_state(opt_state):
    """The optax ``ScaleByAdamState`` (count, mu, nu) inside a chained
    optimizer state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def load_jax_train_state(state, jax_state) -> None:
    """Carry a JAX ``TrainState`` (``pairnet_tpu.train.trainer``) into the
    port's :class:`pairnet_torch.train.trainer.TrainState` in place: the
    params and constants, the AdamW moments ``mu``/``nu`` and ``count``
    (as every parameter's Adam ``step``), ``step`` and ``cum_samples``.
    The random streams differ between the packages and are not carried."""
    model, opt = state.model, state.optimizer
    load_jax_variables(model, _numpy_tree(jax_state.params))
    adam = _adam_state(jax_state.opt_state)
    if adam is None:
        raise ValueError("the JAX optimizer state holds no Adam moments")
    mu = port_arrays(model, {"params": _numpy_tree(adam.mu)})
    nu = port_arrays(model, {"params": _numpy_tree(adam.nu)})
    count = int(np.asarray(adam.count))
    params = dict(model.named_parameters())
    for name, p in params.items():
        opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.tensor(mu[name], device=p.device, dtype=p.dtype),
            "exp_avg_sq": torch.tensor(nu[name], device=p.device, dtype=p.dtype),
        }
    state.step = int(np.asarray(jax_state.step))
    state.cum_samples = torch.from_numpy(np.array(jax_state.cum_samples, np.float32)).to(
        state.cum_samples.device
    )
