"""Port parity: PSGTr, PSGFormer and DETR4Seg of ``pairnet_torch`` against
the JAX package (f32, CPU), with the box ops and the diagnostic fusion.

Tiny widths as the JAX package's own head tests (12 queries, width 32, 4
heads, 2 + 2 transformer layers) on ResNet-26 at base width 8, landscape
2x64x96 images, every weight with seeded noise, carried over by
``load_jax_variables``. Forward outputs are held within ``ATOL`` x
max(1, |JAX|); the losses and their gradients on the same outputs handed to
both packages (each term within ``LOSS_RTOL``, each gradient within
``GRAD_RTOL`` of its max); the Hungarian assignments of every decoder layer
equal to JAX's on those outputs; the post-processed triplets equal, with
the class logits scaled so that the 0.85 keep rule keeps some.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.models.heads import diagnostic as j_diag
from pairnet_tpu.models.heads import psgtr_head as j_psgtr
from pairnet_tpu.models.heads.baseline_head import baseline_postprocess as j_baseline_post
from pairnet_tpu.models.heads.detr4seg_head import Detr4SegHead as JDetr4Seg
from pairnet_tpu.models.heads.detr4seg_head import detr4seg_loss as j_detr4seg_loss
from pairnet_tpu.models.heads.detr4seg_head import detr4seg_postprocess as j_detr4seg_post
from pairnet_tpu.models.heads.psgformer_head import PSGFormerHead as JPSGFormer
from pairnet_tpu.models.heads.psgformer_head import psgformer_loss as j_psgformer_loss
from pairnet_tpu.ops import boxes as j_boxes
from pairnet_tpu.utils.torch_convert import (
    convert_psgformer_checkpoint,
    convert_psgtr_checkpoint,
)
from test_torch_helpers import (
    assert_close_rel,
    decided_ranks,
    numpy_init,
    perturb,
    tree_leaves,
    tree_torch,
    zoo_batch,
    zoo_pair,
)
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.models.heads import baseline_head, detr4seg_head, psgformer_head  # noqa: E402
from pairnet_torch.models.heads import psgtr_head  # noqa: E402
from pairnet_torch.models.heads.diagnostic import diagnostic_postprocess  # noqa: E402
from pairnet_torch.models.heads.pairnet_inference import INSTANCE_OFFSET, NO_OBJ  # noqa: E402
from pairnet_torch.ops import boxes  # noqa: E402
from pairnet_torch.utils.from_jax import _leaves, port_arrays  # noqa: E402

ATOL = 1e-4  # forward outputs: x max(1, max |JAX|)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BOX_ATOL = 1e-6
DETR = dict(num_heads=4, num_encoder_layers=2, num_decoder_layers=2, embed_dims=32)
HEADS = {
    "psgtr": (j_psgtr.PSGTrHead, psgtr_head.PSGTrHead,
              dict(num_classes=7, num_relations=5, num_query=12, **DETR)),
    "psgformer": (JPSGFormer, psgformer_head.PSGFormerHead,
                  dict(num_classes=7, num_relations=5, num_obj_query=12, num_rel_query=10,
                       **DETR)),
    "detr4seg": (JDetr4Seg, detr4seg_head.Detr4SegHead, dict(num_classes=7, num_query=12, **DETR)),
}
NUM_POINTS = 64  # DETR4Seg's mask loss samples


@pytest.fixture(scope="module")
def batch():
    return zoo_batch(seed=0)


@pytest.fixture(scope="module")
def pairs(batch):
    """Per head: (JAX model, variables, JAX outputs, port model, port outputs)."""
    return {name: zoo_pair(jh, ph, kw, batch["image"]) for name, (jh, ph, kw) in HEADS.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items() if k != "image"}


def _points(batch, n=NUM_POINTS):
    """The points JAX draws from its key 0, as the port takes them."""
    B = batch["image"].shape[0]
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (B, n, 2)))


# ------------------------------------------------------------------ box ops


def _boxes(seed, n):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 50, size=(n, 2))
    wh = rng.uniform(0, 30, size=(n, 2))
    wh[0] = 0.0  # a degenerate box
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("op", ["cxcywh_to_xyxy", "xyxy_to_cxcywh", "box_area", "box_iou",
                                "generalized_box_iou", "masks_to_boxes", "mask_iou"])
def test_box_ops_match_jax(op):
    a, b = _boxes(0, 7), _boxes(1, 5)
    rng = np.random.default_rng(2)
    masks = (rng.uniform(size=(6, 12, 17)) > 0.8).astype(np.float32)
    masks[0] = 0.0  # empty
    args = {"cxcywh_to_xyxy": (a,), "xyxy_to_cxcywh": (a,), "box_area": (a,),
            "box_iou": (a, b), "generalized_box_iou": (a, b), "masks_to_boxes": (masks,),
            "mask_iou": (masks, masks[::-1].copy())}[op]
    want = getattr(j_boxes, op)(*map(jnp.asarray, args))
    got = getattr(boxes, op)(*map(torch.tensor, args))
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BOX_ATOL, rtol=0)


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("name", list(HEADS))
def test_forward_matches_jax(pairs, name):
    """Every output, the per-layer lists included, within ATOL x max(1,
    |JAX|); the prototype-matched indices equal where their top-2 gap is
    above the tolerance."""
    _, _, ref, _, out = pairs[name]
    want = dict(tree_leaves(ref))
    got = dict(tree_leaves(out))
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, w in want.items():
        if k in ("sub_pos", "obj_pos"):
            scores = ref["subject_scores" if k == "sub_pos" else "object_scores"]
            top2 = np.sort(scores, axis=-1)[..., -2:]
            ok = top2[..., 1] - top2[..., 0] > 10 * ATOL
            assert ok.mean() > 0.5
            np.testing.assert_array_equal(got[k][ok], w[ok])
        else:
            assert_close_rel(got[k], w, ATOL, k)


def test_mask_head_nearest_upsample_matches_jax():
    """The mask head at FPN sizes that no stride divides, among them one where
    ``F.interpolate(mode="nearest")``'s float index parts from JAX's integer
    rule (i * h // H): the port takes JAX's."""
    sizes = [(h, H) for h in range(3, 40) for H in range(h + 1, 3 * h)
             if not torch.equal(
                 torch.nn.functional.interpolate(torch.arange(h, dtype=torch.float32)[None, None],
                                                 size=H, mode="nearest")[0, 0].long(),
                 torch.arange(H) * h // H)]
    assert sizes, "no size where the float and integer nearest rules differ"
    h, H = sizes[0]
    B, Q, C, heads = 1, 3, 16, 2
    rng = np.random.default_rng(3)
    proj = rng.normal(size=(B, C, 2, h)).astype(np.float32)
    attn = rng.uniform(size=(B, Q, heads, 2, h)).astype(np.float32)
    fpn = [rng.normal(size=(B, 8, 3, H)).astype(np.float32),
           rng.normal(size=(B, 6, 5, H + 3)).astype(np.float32),
           rng.normal(size=(B, 4, 11, 2 * H + 1)).astype(np.float32)]
    jhead = j_psgtr.MaskHeadSmallConv(C + heads, C)
    x = np.concatenate([np.broadcast_to(proj[:, None], (B, Q, C, 2, h)), attn], axis=2)
    x = x.reshape(B * Q, C + heads, 2, h).transpose(0, 2, 3, 1)
    jfpn = [np.repeat(f.transpose(0, 2, 3, 1), Q, axis=0) for f in fpn]
    v = jhead.init(jax.random.PRNGKey(1), x, jfpn)
    want = np.asarray(jhead.apply(v, x, jfpn)).reshape(B, Q, 11, 2 * H + 1)
    head = psgtr_head.MaskHeadSmallConv(C + heads, [8, 6, 4], C)
    arrays = port_arrays(head, {"params": dict(v["params"])})
    head.load_state_dict({k: torch.tensor(a) for k, a in arrays.items()})
    with torch.no_grad():
        got = head(torch.tensor(proj), torch.tensor(attn), [torch.tensor(f) for f in fpn])
    assert_close_rel(got.numpy(), want, ATOL)


@pytest.mark.parametrize("name, convert", [("psgtr", convert_psgtr_checkpoint),
                                           ("psgformer", convert_psgformer_checkpoint)])
def test_converter_closure(pairs, batch, name, convert):
    """The JAX package's converter takes the port's ``state_dict()``: it reads
    every key, gives back every leaf bit for bit, and JAX's forward on what
    it gives equals the port's."""
    jm, variables, _, _, out = pairs[name]
    port = pairs[name][3]

    class Tracked(dict):
        read = set()

        def __getitem__(self, k):
            self.read.add(k)
            return dict.__getitem__(self, k)

    sd = Tracked({k: v.numpy() for k, v in port.state_dict().items()})
    back = convert(sd)
    assert set(sd) == sd.read, sorted(set(sd) - sd.read)
    for col in ("params", "constants"):
        want = dict(_leaves(variables[col]))
        got = dict(_leaves(back[col]))
        assert set(want) == set(got), sorted(set(want) ^ set(got))
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg="/".join(k))
    ref = jax.jit(jm.apply)(back, batch["image"])
    for k in ("sub_seg" if name == "psgtr" else "mask", "rel"):
        assert_close_rel(out[k], np.asarray(ref[k]), ATOL, k)


# ------------------------------------------------------------------ training


class Recorder:
    """Wraps ``batched_hungarian`` of a module: counts its calls and keeps
    their row2col."""

    def __init__(self, module, monkeypatch):
        self.calls = []
        orig = module.batched_hungarian

        def rec(cost, row_mask=None, col_mask=None):
            res = orig(cost, row_mask, col_mask)
            self.calls.append(res[0].numpy())
            return res

        monkeypatch.setattr(module, "batched_hungarian", rec)


def _j_psgtr_assign(ref, batch):
    """JAX's HTriMatcher for every decoder layer: (L, B, Q)."""
    G = batch["gt_labels"].shape[1]

    def single(s_c, o_c, r_c, s_b, o_b, labels, boxes_, rels, rv, hw):
        sub = jnp.clip(rels[:, 0], 0, G - 1)
        obj = jnp.clip(rels[:, 1], 0, G - 1)
        scale = jnp.concatenate([hw[::-1], hw[::-1]]).astype(jnp.float32)

        def norm(bx):
            return jnp.clip(jnp.stack([(bx[:, 0] + bx[:, 2]) / 2 / scale[0],
                                       (bx[:, 1] + bx[:, 3]) / 2 / scale[1],
                                       (bx[:, 2] - bx[:, 0]) / scale[0],
                                       (bx[:, 3] - bx[:, 1]) / scale[1]], -1), 0, 1)

        return j_psgtr.htri_match(s_c, o_c, r_c, s_b, o_b, norm(boxes_[sub]), norm(boxes_[obj]),
                                  labels[sub], labels[obj], rels[:, 2], rv, hw)

    L = ref["layers"]
    jb = _jbatch(batch)
    return np.stack([np.asarray(jax.vmap(single)(
        L["sub"][li], L["obj"][li], L["rel"][li], L["sub_box"][li], L["obj_box"][li],
        jb["gt_labels"], jb["gt_boxes"], jb["gt_rels"], jb["rel_valid"], jb["image_shape"]))
        for li in range(len(L["sub"]))])


def _j_psgformer_assign(ref, batch):
    """JAX's object matcher for every layer (L, B, Q) and the relation
    matcher on the last (B, K)."""
    from pairnet_tpu.models.heads.psgformer_head import _normalize_boxes
    from pairnet_tpu.models.matchers import classification_cost
    from pairnet_tpu.ops.hungarian import hungarian

    jb = _jbatch(batch)
    G = batch["gt_labels"].shape[1]

    def obj(cls_p, box_p, labels, bx, valid, hw):
        gt_n = _normalize_boxes(bx, hw)
        factor = jnp.stack([hw[1], hw[0], hw[1], hw[0]]).astype(jnp.float32)
        cost = (4.0 * classification_cost(cls_p, labels)
                + 3.0 * jnp.abs(box_p[:, None] - gt_n[None]).sum(-1)
                + 2.0 * -j_boxes.generalized_box_iou(j_boxes.cxcywh_to_xyxy(box_p) * factor, bx))
        return hungarian(cost, col_mask=valid)

    per_layer = [jax.vmap(obj)(c, b, jb["gt_labels"], jb["gt_boxes"], jb["gt_valid"],
                               jb["image_shape"]) for c, b in zip(ref["cls_layers"],
                                                                   ref["box_layers"])]
    g2q = per_layer[-1][1]

    def rel(sub_s, obj_s, rel_s, g2q_i, rels, rv):
        sub_gt = jnp.clip(rels[:, 0], 0, G - 1)
        obj_gt = jnp.clip(rels[:, 1], 0, G - 1)
        ok = rv & (g2q_i[sub_gt] >= 0) & (g2q_i[obj_gt] >= 0)
        cost = (classification_cost(sub_s, jnp.where(ok, g2q_i[sub_gt], 0))
                + classification_cost(obj_s, jnp.where(ok, g2q_i[obj_gt], 0))
                + classification_cost(rel_s, rels[:, 2]))
        return hungarian(cost, col_mask=ok)[0]

    relq2gt = jax.vmap(rel)(ref["subject_scores"], ref["object_scores"], ref["rel"], g2q,
                            jb["gt_rels"], jb["rel_valid"])
    return np.stack([np.asarray(q) for q, _ in per_layer]), np.asarray(relq2gt)


def _j_detr4seg_assign(ref, batch):
    """JAX's DETR4Seg matcher for every layer: (L, B, Q)."""
    from pairnet_tpu.models.matchers import classification_cost
    from pairnet_tpu.ops.hungarian import hungarian

    jb = _jbatch(batch)

    def single(cls, box, labels, bx, valid, hw):
        hw = hw.astype(jnp.float32)
        scale = jnp.concatenate([hw[::-1], hw[::-1]])
        b = bx / jnp.maximum(scale, 1.0)
        gt_n = jnp.clip(jnp.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                                   b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], -1), 0.0, 1.0)
        cost = classification_cost(cls, labels)
        cost = cost + 5.0 * jnp.abs(box[:, None] - gt_n[None]).sum(-1)
        giou = j_boxes.generalized_box_iou(j_boxes.cxcywh_to_xyxy(box) * scale,
                                           j_boxes.cxcywh_to_xyxy(gt_n) * scale)
        return hungarian(cost + 2.0 * (-giou), col_mask=valid)[0]

    return np.stack([np.asarray(jax.vmap(single)(c, b, jb["gt_labels"], jb["gt_boxes"],
                                                 jb["gt_valid"], jb["image_shape"]))
                     for c, b in zip(ref["layers"]["cls"], ref["layers"]["box"])])


def _float_outputs(ref):
    """The head's outputs without the integer indices (the losses read none)."""
    return {k: v for k, v in ref.items() if not np.issubdtype(np.asarray(v).dtype, np.integer)
            or isinstance(v, (dict, list))}


def _port_loss(name, outputs, batch):
    tb = tree_torch({k: v for k, v in batch.items() if k != "image"})
    if name == "psgtr":
        return psgtr_head.psgtr_loss(outputs, tb, num_classes=7)
    if name == "psgformer":
        return psgformer_head.psgformer_loss(outputs, tb, num_classes=7)
    return detr4seg_head.detr4seg_loss(outputs, tb, torch.tensor(_points(batch)), num_classes=7)


def _jax_loss(name, outputs, batch):
    jb = _jbatch(batch)
    if name == "psgtr":
        return j_psgtr.psgtr_loss(outputs, jb, num_classes=7, num_relations=5)
    if name == "psgformer":
        return j_psgformer_loss(outputs, jb, jax.random.PRNGKey(0), num_classes=7)
    return j_detr4seg_loss(outputs, jb, jax.random.PRNGKey(0), num_classes=7,
                           num_points=NUM_POINTS)


@pytest.fixture(scope="module")
def jax_losses(pairs, batch):
    """Per head: JAX's losses on its outputs and their gradient with
    respect to every output."""
    res = {}
    for name in HEADS:
        ref = _float_outputs(pairs[name][2])
        fn = jax.jit(jax.value_and_grad(
            lambda o, n=name: (lambda ls: (ls["loss_total"], ls))(_jax_loss(n, o, batch)),
            has_aux=True))
        (_, losses), grads = fn(jax.tree_util.tree_map(jnp.asarray, ref))
        res[name] = ({k: float(v) for k, v in losses.items()},
                     jax.tree_util.tree_map(np.asarray, grads))
    return res


@pytest.mark.parametrize("name, n_calls", [("psgtr", 1), ("psgformer", 2), ("detr4seg", 1)])
def test_hungarian_matches_jax(pairs, batch, monkeypatch, name, n_calls):
    """On JAX's outputs, every (layer, image) assignment of the port equals
    JAX's; one Hungarian call covers every layer (PSGFormer: a second, the
    relation matcher)."""
    ref = pairs[name][2]
    module = {"psgtr": psgtr_head, "psgformer": psgformer_head, "detr4seg": detr4seg_head}[name]
    rec = Recorder(module, monkeypatch)
    if name == "psgformer":
        rec2 = Recorder(baseline_head, monkeypatch)
    _port_loss(name, tree_torch(ref), batch)
    B = batch["image"].shape[0]
    if name == "psgtr":
        want = _j_psgtr_assign(ref, batch)
    elif name == "psgformer":
        want, want_rel = _j_psgformer_assign(ref, batch)
        assert len(rec2.calls) == 1
        np.testing.assert_array_equal(rec2.calls[0], want_rel)
        assert (want_rel >= 0).sum() > 0
    else:
        want = _j_detr4seg_assign(ref, batch)
    assert len(rec.calls) + (name == "psgformer") == n_calls
    got = rec.calls[0].reshape(-1, B, want.shape[-1])
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).sum() > 0


@pytest.mark.parametrize("name", list(HEADS))
def test_loss_matches_jax(pairs, batch, jax_losses, name):
    """The same outputs to both packages: every loss term within LOSS_RTOL."""
    ref = _float_outputs(pairs[name][2])
    want = jax_losses[name][0]
    got = {k: float(v) for k, v in _port_loss(name, tree_torch(ref), batch).items()}
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, w in want.items():
        assert abs(got[k] - w) <= LOSS_RTOL * abs(w) + 1e-7, (k, got[k], w)


@pytest.mark.parametrize("name", list(HEADS))
def test_loss_gradients_match_jax(pairs, batch, jax_losses, name):
    """The loss's gradient with respect to every output within GRAD_RTOL of
    the gradient's max."""
    ref = _float_outputs(pairs[name][2])
    outputs = tree_torch(ref, grad=True)
    _port_loss(name, outputs, batch)["loss_total"].backward()
    want = dict(tree_leaves(jax_losses[name][1]))
    n = 0
    for k, t in tree_leaves(outputs):
        if not t.is_floating_point():
            continue
        got = t.grad.numpy() if t.grad is not None else np.zeros(t.shape, np.float32)
        w = want[k]
        scale = float(np.abs(w).max(initial=0.0))
        n += scale > 0
        assert float(np.abs(got - w).max()) <= GRAD_RTOL * scale + 1e-9, (k, scale)
    assert n >= 3


def _module_case(name, rng):
    """(JAX module, its inputs, the port module, the port's prefix inside a
    PSGTr head, the flax path of that prefix): each DETR-side module of the
    zoo at tiny widths."""
    C, heads, Q = 32, 4, 12
    tok = rng.normal(size=(2, 6, C)).astype(np.float32)
    pos = rng.normal(size=(1, 6, C)).astype(np.float32)
    qe = rng.normal(size=(Q, C)).astype(np.float32)
    if name == "transformer":
        return (j_psgtr.DETRTransformer(C, heads, 2, 2, 64), (tok, pos, qe),
                psgtr_head.DETRTransformer(C, heads, 2, 2, 64), "bbox_head.transformer.",
                ("bbox_head", "transformer"))
    if name == "dual_transformer":
        from pairnet_tpu.models.heads.psgformer_head import DualTransformer

        return (DualTransformer(C, heads, 2, 2, 64), (tok, pos, qe, qe[:10]),
                psgtr_head.DETRTransformer(C, heads, 2, 2, 64, decoders=("decoder1", "decoder2")),
                "bbox_head.transformer.", ("bbox_head", "transformer"))
    if name == "attention_map":
        q = rng.normal(size=(2, Q, C)).astype(np.float32)
        k = rng.normal(size=(2, 3, 5, C)).astype(np.float32)
        return (j_psgtr.MHAttentionMap(C, C, heads), (q, k), psgtr_head.MHAttentionMap(C, C, heads),
                "bbox_head.sub_bbox_attention.", ("bbox_head", "sub_bbox_attention"))
    x = rng.normal(size=(2, Q, C)).astype(np.float32)
    return (j_psgtr.MLP(C, 4, 3), (x,), psgtr_head.DetrMLP(C, C, 4, 3), "bbox_head.sub_box_embed.",
            ("bbox_head", "sub_box_embed"))


def _to_port_inputs(name, args):
    if name == "attention_map":
        return [torch.tensor(args[0]), torch.tensor(args[1]).permute(0, 3, 1, 2)]
    return [torch.tensor(a) for a in args]


@pytest.mark.parametrize("name", ["transformer", "dual_transformer", "attention_map", "mlp"])
def test_module_gradients_match_jax(name):
    """Each DETR-side module on random inputs and a random cotangent: the
    gradient of every parameter and input within GRAD_RTOL of its max.
    (Held per module rather than through the whole model: a ReLU input
    within rounding of zero takes another side in each package, and one
    such unit moves its layer's gradient by a few percent. On the tiny
    PSGTr fixture one unit of the last decoder layer's FFN, at 1.2e-7,
    does so between JAX's own f32 and f64 runs; the loss's gradient with
    respect to every output is held in ``test_loss_gradients_match_jax``.)"""
    rng = np.random.default_rng(4)
    jmod, args, pmod, prefix, path = _module_case(name, rng)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args)
    variables = perturb(numpy_init(shapes, 6), seed=5, std=0.05)
    out = jax.eval_shape(lambda p: jmod.apply({"params": p}, *args), variables["params"])
    cot = jax.tree_util.tree_map(lambda o: rng.normal(size=o.shape).astype(np.float32), out)
    grads = jax.jit(lambda p, a, c: jax.vjp(lambda p, *a: jmod.apply({"params": p}, *a), p, *a)[1](c))(
        variables["params"], args, cot)
    nested = lambda tree: {path[0]: {path[1]: tree}}  # noqa: E731
    arrays = port_arrays(pmod, {"params": nested(dict(variables["params"]))}, prefix)
    pmod.load_state_dict({k: torch.tensor(a) for k, a in arrays.items()})
    inputs = [t.requires_grad_() for t in _to_port_inputs(name, args)]
    pout = pmod(*inputs)
    total = sum((p * torch.tensor(np.asarray(c))).sum()
                for p, c in zip(jax.tree_util.tree_leaves(_torch_tree(pout)),
                                jax.tree_util.tree_leaves(cot)))
    total.backward()
    want = port_arrays(pmod, {"params": nested(jax.tree_util.tree_map(np.asarray, grads[0]))},
                       prefix)
    # a gradient that is 0 up to rounding (a key bias shifts a whole softmax
    # row alike; the first DETR decoder layer attends over zero queries, so
    # its self-attention's projections get none) is held to be 0 in both:
    # within 1e-5 of the module's largest gradient
    zero = 1e-5 * max(float(np.abs(w).max()) for w in want.values())
    for n, p in pmod.named_parameters():
        scale = float(np.abs(want[n]).max())
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        if scale <= zero:
            assert float(np.abs(got).max()) <= zero, n
        else:
            assert float(np.abs(got - want[n]).max()) <= GRAD_RTOL * scale, n
    for t, g in zip(_to_port_inputs(name, [np.asarray(g) for g in grads[1:]]), inputs):
        assert_close_rel(g.grad.numpy(), t.numpy(), GRAD_RTOL, "input")


def _torch_tree(out):
    """The port module's output as the JAX module's tree of leaves (the
    transformer's ``([outs], mem)`` as ``(outs, mem)``; the dual
    transformer's as ``(outs1, outs2, mem)``)."""
    if isinstance(out, tuple) and isinstance(out[0], list):
        outs, mem = out
        return (*outs, mem) if len(outs) > 1 else (outs[0], mem)
    return out


# ------------------------------------------------------------------ inference


def _confident(tree, keys, peak=20.0):
    """``tree`` with the class logits of ``keys`` scaled to a largest
    magnitude of ``peak``, so that class probabilities pass the 0.85 keep
    rule."""
    return {k: (v * (peak / np.abs(v).max()) if k in keys else v) for k, v in tree.items()
            if not isinstance(v, (dict, list))}


@pytest.mark.parametrize("name, b", [(n, b) for n in HEADS for b in (0, 1)])
def test_postprocess_matches_jax(pairs, name, b):
    """The same outputs to both post-processings: labels, ranked predicate
    labels and scores, masks and the panoptic map equal, every top-k rank
    decided by a margin."""
    ref = pairs[name][2]
    num_things = 4
    if name == "psgtr":
        out = _confident(ref, ("sub", "obj"))
        j = j_psgtr.psgtr_postprocess({k: jnp.asarray(v) for k, v in out.items()}, b, num_things)
        t = psgtr_head.psgtr_postprocess(tree_torch(out), b, num_things)
    elif name == "psgformer":
        out = _confident(ref, ("cls", "sub", "obj"))
        j = j_baseline_post({k: jnp.asarray(v) for k, v in out.items()}, b, num_things)
        t = psgformer_head.psgformer_postprocess(tree_torch(out), b, num_things)
    else:
        out = _confident(ref, ("cls",))
        j = j_detr4seg_post({k: jnp.asarray(v) for k, v in out.items()}, b, num_things)
        t = detr4seg_head.detr4seg_postprocess(tree_torch(out), b, num_things)
    if name != "detr4seg":
        probs = np.asarray(jax.nn.softmax(out["rel"][b], -1))[:, 1:].ravel()
        K = out["rel"].shape[1]
        assert decided_ranks(probs, K, 1e-6).all()
    for field in ("labels", "rel_pairs", "masks", "pan_seg", "r_labels"):
        np.testing.assert_array_equal(getattr(t, field).numpy(), np.asarray(getattr(j, field)),
                                      err_msg=field)
    for field in ("r_scores", "r_dists"):
        np.testing.assert_allclose(getattr(t, field).numpy(), np.asarray(getattr(j, field)),
                                   atol=1e-6, rtol=0, err_msg=field)
    if name == "psgtr":  # the keep rule kept something: the fusion ran
        assert (np.asarray(j.pan_seg) != INSTANCE_OFFSET + NO_OBJ).any()


@pytest.mark.parametrize("mapping", [None, "reversed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_diagnostic_postprocess_matches_jax(seed, mapping):
    """Confident random logits through the diagnostic fusion, with and
    without a label mapping."""
    rng = np.random.default_rng(seed)
    Q, C, H, W = 10, 6, 20, 28
    cls = (rng.normal(size=(1, Q, C + 1)) * 5).astype(np.float32)
    mask = (rng.normal(size=(1, Q, H, W)) * 3).astype(np.float32)
    table = None if mapping is None else np.arange(C)[::-1].copy()
    j = j_diag.diagnostic_postprocess({"cls": jnp.asarray(cls), "mask": jnp.asarray(mask)}, 0,
                                      num_things=3, label_mapping=table)
    t = diagnostic_postprocess({"cls": torch.tensor(cls), "mask": torch.tensor(mask)}, 0,
                               num_things=3, label_mapping=table)
    for field in t._fields:
        np.testing.assert_array_equal(getattr(t, field).numpy(), np.asarray(getattr(j, field)),
                                      err_msg=field)
    assert math.prod(np.unique(np.asarray(j.labels)).shape) > 1
