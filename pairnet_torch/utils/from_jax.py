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

import os
import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

from pairnet_torch.models.backbones.swin import PatchMerging, WindowMSA
from pairnet_torch.models.frameworks.panoptic_fpn import ChwLinear
from pairnet_torch.models.heads.pairnet_bbox_head import CrossHeadBBox, DeformableDetrTransformer
from pairnet_torch.models.heads.twostage.contexts import DecoderRNN
from pairnet_torch.models.heads.twostage.core import RunningBatchNorm
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


# the two-stage models' names (``convert_panoptic_fpn``, ``convert_motif_head``,
# ``convert_imp_head``, ``convert_gps_head``, ``convert_vctree_head``): mmdet's
# FPN, Panoptic FPN heads and the reference's relation heads
_TWO_STAGE_RULES = [
    (r"^neck\.lateral_convs\.(\d+)\.conv" + _E, r"neck.lateral_\1"),
    (r"^neck\.fpn_convs\.(\d+)\.conv" + _E, r"neck.fpn_conv_\1"),
    (r"^roi_head\.", ""),
    (r"^bbox_head\.shared_fcs\.([01])" + _E, lambda m: f"bbox_head.shared_fc{int(m.group(1)) + 1}"),
    (r"^mask_head\.convs\.(\d)\.conv" + _E, r"mask_head.conv\1"),
    (r"^semantic_head\.conv_upsample_layers\.(\d)\.conv\.(\d)\.(conv|gn)" + _E,
     r"semantic_head.up\1_\3\2"),
    (r"\.visual_bbox_head\.0" + _E, ".fc1"),
    (r"\.visual_bbox_head\.2" + _E, ".fc2"),
    (r"\.spatial_conv\.0\.(conv|bn)" + _E, r".spatial.\g<1>1"),
    (r"\.spatial_conv\.2\.(conv|bn)" + _E, r".spatial.\g<1>2"),
    (r"\.pos_embed\.0" + _E, ".pos_fc1"),
    (r"\.pos_embed\.1" + _E, ".pos_bn"),
    (r"\.pos_embed\.2" + _E, ".pos_fc2"),
    (r"\.(box|overlap)_embed\.0" + _E, r".\1_embed"),
    (r"\.(box|overlap)_embed\.1" + _E, r".\1_bn"),
    (r"\.(sub_vert|obj_vert|out_edge|in_edge)_w_fc\.0" + _E, r".\1_w_fc"),
    (r"\.(project_input|W_t3)\.0" + _E, r".\1"),
    (r"\.trans\.0" + _E, ".t1"),
    (r"\.trans\.1" + _E, ".t_ln"),
    (r"\.trans\.3" + _E, ".t2"),
    (r"\.multi_layer_lstm\.0\.treeLSTM_foreward\.treeLSTM" + _E, ".fwd"),
    (r"\.multi_layer_lstm\.0\.treeLSTM_backward\.treeLSTM" + _E, ".bwd"),
    (r"\.freq_bias\.obj_baseline" + _E, ".freq_bias.pred_baseline"),
]


def _twostage_rules(model: nn.Module, prefix: str = ""):
    """The two-stage models' renames (for a model of, or a module inside,
    the two-stage frameworks), with the MOTIFS label decoder's parameters
    under its flax scan's ``step``; None for another model."""
    kinds = ("pairnet_torch.models.frameworks.panoptic_fpn", "pairnet_torch.models.necks.fpn",
             "pairnet_torch.models.frameworks.twostage", "pairnet_torch.models.heads.twostage.")
    if not any(type(m).__module__.startswith(kinds) for m in model.modules()):
        return None
    names = [(prefix + name).rstrip(".") for name, m in model.named_modules()
             if isinstance(m, DecoderRNN)]
    steps = [(r"^" + re.escape(name) + r"\.", name + ".step.") for name in names]
    return steps + _TWO_STAGE_RULES


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
    if isinstance(module, ChwLinear):  # the JAX kernel's rows are (h, w, c)
        c, h, w = module.roi_shape
        yield "weight", "params", "kernel", lambda a: (
            a.T.reshape(-1, h, w, c).transpose(0, 3, 1, 2).reshape(a.shape[1], -1))
        yield "bias", "params", "bias", None
    elif isinstance(module, nn.Linear):
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
    elif isinstance(module, nn.ConvTranspose2d):  # flax's taps are spatially flipped
        yield "weight", "params", "kernel", lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1)
        yield "bias", "params", "bias", None
    elif isinstance(module, FrozenBatchNorm):
        for n in ("weight", "bias", "running_mean", "running_var"):
            yield n, "constants", n, None
    elif isinstance(module, RunningBatchNorm):
        yield "weight", "params", "scale", None
        yield "bias", "params", "bias", None
        yield "running_mean", "batch_stats", "mean", None
        yield "running_var", "batch_stats", "var", None
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


def _recurrent_leaves(module, base):
    """An ``nn.LSTM`` (flax ``OptimizedLSTMCell`` under a masked scan: gates
    i, f, g, o as ``i*`` / ``h*`` Dense kernels, the summed biases on
    ``h*``, which the port carries in ``bias_ih`` with ``bias_hh`` zero) or an
    ``nn.GRUCell`` (flax ``GRUCell``: gates r, z, n; the summed r/z biases
    on ``ir`` / ``iz``, the input- and hidden-side n biases on ``in`` /
    ``hn``; the port's ``bias_hh`` r/z chunks zero)."""
    cat_t = lambda arrs: np.concatenate([a.T for a in arrs])  # noqa: E731
    if isinstance(module, nn.GRUCell):
        gates = [base + (f"{side}{g}",) for side in "ih" for g in "rzn"]
        ih, hh = gates[:3], gates[3:]
        yield "weight_ih", "params", [p + ("kernel",) for p in ih], cat_t
        yield "weight_hh", "params", [p + ("kernel",) for p in hh], cat_t
        yield "bias_ih", "params", [p + ("bias",) for p in ih], np.concatenate
        yield "bias_hh", "params", [hh[2] + ("bias",)], lambda arrs: np.concatenate(
            [np.zeros_like(arrs[0]), np.zeros_like(arrs[0]), arrs[0]])
        return
    dirs = [("", ("fwd",)), ("_reverse", ("bwd",))] if module.bidirectional else [("", ())]
    for suffix, d in dirs:
        cell = base + d + ("step", "cell")
        hs = [cell + (f"h{g}",) for g in "ifgo"]
        yield f"weight_ih_l0{suffix}", "params", [cell + (f"i{g}", "kernel") for g in "ifgo"], cat_t
        yield f"weight_hh_l0{suffix}", "params", [p + ("kernel",) for p in hs], cat_t
        yield f"bias_ih_l0{suffix}", "params", [p + ("bias",) for p in hs], np.concatenate
        yield f"bias_hh_l0{suffix}", "params", [p + ("bias",) for p in hs], lambda arrs: (
            np.zeros_like(np.concatenate(arrs)))


def tensor_leaves(model: nn.Module, prefix: str = ""):
    """For every parameter and buffer of ``model``: (port tensor name,
    collection, the flax leaf paths it is made of, numpy leaves -> torch
    layout). A packed attention in_proj is made of three leaves
    (q_proj, k_proj, v_proj); every other tensor of one."""
    T = lambda a: a.T  # noqa: E731
    merges = []  # PatchMerging names: their children's tensors are yielded with them
    m2f = _has_m2f(model)
    bbox = _bbox_geometry(model)
    twostage = _twostage_rules(model, prefix)
    rules = (_bbox_rules(*bbox) + _RULES if bbox else twostage + _RULES if twostage
             else _RULES)
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
        if isinstance(module, (nn.LSTM, nn.GRUCell)):
            for tname, col, paths, fn in _recurrent_leaves(module, base):
                yield dst_prefix + tname, col, paths, fn
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
        model, {col: variables.get(col, {}) for col in ("params", "constants", "batch_stats")},
        prefix)
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


EXPORT_STEP = "__step__"  # the orbax step that ``tools/export_orbax.py`` stores


def read_jax_export(path: str) -> tuple[dict, int | None]:
    """An ``.npz`` of ``"/"``-flattened leaves as a nested tree, and the
    orbax step (JAX's epoch) that ``tools/export_orbax.py`` stored in it;
    None for an ``.npz`` of flax variables, which has none."""
    with np.load(path) as f:
        flat = dict(f)
    step = flat.pop(EXPORT_STEP, None)
    return unflatten(flat), None if step is None else int(step)


def load_pretrained(model: nn.Module, path: str) -> nn.Module:
    """Warm-start ``model`` in place from ``path``, by what it is:

    * a reference PyTorch checkpoint ``.pth``
      (:func:`pairnet_torch.utils.torch_convert.load_reference_checkpoint`,
      the Mask2Former segmenter's included);
    * an ``.npz`` of ``"/"``-flattened flax variables, or an export of a
      JAX orbax checkpoint (``tools/export_orbax.py``), whose ``params``
      subtree (the variables) is taken as JAX's ``tools/train.py`` takes
      ``raw["params"]`` (:func:`merge_pretrained`);
    * a port checkpoint ``ckpts/epoch_<n>.pt``, whose model state is
      overlaid.

    Every route overlays: an unknown key or a shape mismatch raises, a
    tensor the file lacks keeps its init. A directory (a JAX orbax
    checkpoint, which the port cannot read) raises ``ValueError``."""
    if os.path.isdir(path):
        raise ValueError(
            f"load_from {path!r} is a directory: a JAX orbax checkpoint, which the port does "
            f"not read. Export it where JAX is installed, `python tools/export_orbax.py {path} "
            "--out weights.npz`, and load the .npz")
    if path.endswith(".npz"):
        tree, step = read_jax_export(path)
        return merge_pretrained(model, tree if step is None else tree["params"])
    from pairnet_torch.utils.torch_convert import load_reference_checkpoint

    if path.endswith(".pth"):
        load_reference_checkpoint(model, path)
    elif path.endswith(".pt"):
        load_reference_checkpoint(
            model, torch.load(path, map_location="cpu", weights_only=True)["state"]["model"])
    else:
        raise ValueError(f"load_from {path!r}: expected an .npz of flax variables, a port "
                         "checkpoint .pt or a reference checkpoint .pth")
    return model


def _numpy_tree(tree):
    """A mapping tree (dict, FrozenDict) as nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _field(obj, name):
    """``obj[name]`` of a restored tree, or the attribute of a ``TrainState``."""
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _adam_state(opt_state):
    """``(count, mu, nu)`` of the Adam moments inside a chained optax state:
    a ``ScaleByAdamState``, or the ``{count, mu, nu}`` dict that a
    target-free orbax restore (lists for tuples, None for empty states) or
    its export (dicts with digit keys) holds; None if there is none."""
    if isinstance(opt_state, Mapping):
        if "mu" in opt_state and "nu" in opt_state:
            return opt_state["count"], opt_state["mu"], opt_state["nu"]
        children = [opt_state[k] for k in sorted(opt_state, key=lambda k: (len(k), k))]
    elif hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state.count, opt_state.mu, opt_state.nu
    elif isinstance(opt_state, (tuple, list)):
        children = opt_state
    else:
        return None
    for s in children:
        found = _adam_state(s)
        if found is not None:
            return found
    return None


def load_jax_train_state(state, jax_state) -> None:
    """Carry a JAX training state into the port's
    :class:`pairnet_torch.train.trainer.TrainState` in place: the variables
    (params, constants, batch_stats), the AdamW moments ``mu``/``nu`` and
    ``count`` (as every parameter's Adam ``step``), ``step`` and
    ``cum_samples``. ``jax_state`` is a ``pairnet_tpu.train.trainer.TrainState``
    or the raw tree of its checkpoint (a target-free orbax restore, or its
    ``tools/export_orbax.py`` export read back): nested dicts and lists
    whose ``params`` is the whole variables dict. The random streams differ
    between the packages and are not carried."""
    model, opt = state.model, state.optimizer
    load_jax_variables(model, _numpy_tree(_field(jax_state, "params")))
    adam = _adam_state(_field(jax_state, "opt_state"))
    if adam is None:
        raise ValueError("the JAX optimizer state holds no Adam moments")
    count, mu, nu = adam
    mu = port_arrays(model, {"params": _numpy_tree(mu)})
    nu = port_arrays(model, {"params": _numpy_tree(nu)})
    count = int(np.asarray(count))
    for name, p in model.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.tensor(mu[name], device=p.device, dtype=p.dtype),
            "exp_avg_sq": torch.tensor(nu[name], device=p.device, dtype=p.dtype),
        }
    state.step = int(np.asarray(_field(jax_state, "step")))
    cum = np.array(_field(jax_state, "cum_samples"), np.float32)
    if cum.shape != tuple(state.cum_samples.shape):
        raise ValueError(f"cum_samples: JAX {cum.shape} vs port {tuple(state.cum_samples.shape)}")
    state.cum_samples = torch.from_numpy(cum).to(state.cum_samples.device)
