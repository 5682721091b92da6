"""Port parity: the box Pair-Net (``CrossHeadBBox`` on Deformable-DETR) of
``pairnet_torch`` against ``pairnet_tpu`` (f32, CPU; bf16 block by block).

The tiny head of the JAX package's own test (``tests/test_bbox_head.py``):
10 classes, 5 predicates, 16 object and 12 relation queries, width 32, 4
heads, 2 + 2 + 2 layers, 4 levels, on ResNet-26 at base width 8, 2x64x64
images; every weight with seeded noise, carried over by
``load_jax_variables``. JAX's MSDA takes its plain path on the CPU and the
port its plain versions.

* the submodules (ChannelMapper, the encoder layer at 4 levels, the
  decoder layer on 4-d box references, the RMSNorm relation layer, RMSNorm,
  the chunked SwiGLU, SwiGLU) within ``MODULE_ATOL``;
* the whole forward, every output within ``FORWARD_ATOL`` x max(1, |JAX|),
  the three discrete steps (proposal top-k, query re-rank, pair top-k)
  decided by a margin of 10x the gap between the packages' ranked values;
* the focal costs and losses, the box assignments (equal), the Pair-Net
  and detection-only losses within ``LOSS_RTOL`` and their gradients
  within ``GRAD_RTOL`` of each gradient's max, per-module gradients, the
  post-processing;
* a bf16 forward block by block (``BF16_RTOL``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.models import losses as j_losses
from pairnet_tpu.models import matchers as j_matchers
from pairnet_tpu.models.backbones.resnet import ResNet as JResNet
from pairnet_tpu.models.frameworks.psgtr import PSGTr as JPSGTr
from pairnet_tpu.models.heads import pairnet_bbox_head as jb
from pairnet_tpu.models.layers import RMSNorm as JRMSNorm
from pairnet_tpu.models.layers import SwiGLU as JSwiGLU
from pairnet_tpu.models.necks.pixel_decoder import DeformableEncoderLayer as JEncLayer
from test_bbox_head import _tiny_bbox_batch
from test_torch_helpers import (  # noqa: F401  (keep_torch_rng: the module's RNG guard)
    assert_close_rel,
    decided_ranks,
    keep_torch_rng,
    numpy_init,
    perturb,
    tree_leaves,
    tree_numpy,
    tree_torch,
)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.models import losses, matchers  # noqa: E402
from pairnet_torch.models.backbones.resnet import ResNet  # noqa: E402
from pairnet_torch.models.frameworks.psgtr import PSGTr  # noqa: E402
from pairnet_torch.models.heads import pairnet_bbox_head as pb  # noqa: E402
from pairnet_torch.models.layers import SwiGLU  # noqa: E402
from pairnet_torch.utils.from_jax import load_jax_variables  # noqa: E402

KW = dict(num_classes=10, num_relations=5, num_obj_query=16, num_rel_query=12, embed_dims=32,
          num_heads=4, num_encoder_layers=2, num_decoder_layers=2, num_relation_layers=2,
          num_levels=4)
C, NH, L = 32, 4, 4
TINY_SHAPES = ((8, 8), (4, 4), (2, 2), (1, 1))  # the neck's levels at 64x64
MODULE_ATOL = 1e-5
FORWARD_ATOL = 1e-4  # x max(1, max |JAX|)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BF16_RTOL = 2e-2  # x max |JAX|, per block (as the Swin blocks: rounding at other points)


def port_model():
    bb = ResNet(depth=26, base_width=8)
    return PSGTr(bb, pb.CrossHeadBBox(**KW), pb.ChannelMapper(bb.out_channels[1:], C, L))


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, variables, images, JAX outputs, port model, port outputs)."""
    jm = JPSGTr(backbone=JResNet(depth=26, base_width=8), bbox_head=jb.CrossHeadBBox(**KW))
    images = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    variables = perturb(numpy_init(shapes, 2), seed=2, std=0.05)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(jm.apply)(variables, images))
    port = load_jax_variables(port_model().eval(), variables)
    with torch.no_grad():
        out = tree_numpy(port(torch.tensor(images)))
    return jm, variables, images, ref, port, out


def _boxes(rng, *lead):
    """Random cxcywh boxes: centres in [0, 1], w and h in [0.05, 1]."""
    b = rng.uniform(size=(*lead, 4)).astype(np.float32)
    b[..., 2:] = b[..., 2:] * 0.95 + 0.05
    return b


def _module_case(name, port, rng):
    """(JAX module, its flax path under bbox_head, JAX inputs, the port
    module, port inputs) of one submodule at the tiny widths."""
    head = port.bbox_head
    B, Q, K = 2, KW["num_obj_query"], KW["num_rel_query"]
    S = sum(h * w for h, w in TINY_SHAPES)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    if name == "neck":
        # the levels of a 128x128 image: at the fixture's 64x64 the extra
        # level is 1x1, where each GroupNorm group holds one value of
        # variance 0 (JAX's own bf16 result there moves by the whole value
        # between jit and eager)
        feats = [f(B, 16, 16, 64), f(B, 8, 8, 128), f(B, 4, 4, 256)]
        return (jb.ChannelMapper(C, L), ("neck",), (feats,), port.neck,
                ([torch.tensor(x).permute(0, 3, 1, 2) for x in feats],))
    if name == "encoder_layer":
        x, pos = f(B, S, C), f(B, S, C)
        ref = np.broadcast_to(rng.uniform(size=(1, S, 1, 2)), (B, S, L, 2)).astype(np.float32)
        return (JEncLayer(C, NH, L, 4, 1024), ("enc_0",), (x, pos, ref, TINY_SHAPES),
                head.transformer.encoder.layers[0],
                (torch.tensor(x), torch.tensor(pos), torch.tensor(ref), TINY_SHAPES))
    if name == "decoder_layer":
        q, qpos, mem = f(B, Q, C), f(B, Q, C), f(B, S, C)
        ref = np.broadcast_to(_boxes(rng, B, Q, 1), (B, Q, L, 4)).copy()
        args = (q, qpos, mem, ref)
        return (jb.DeformableDecoderLayer(C, NH, L, 4, 1024), ("dec_0",), (*args, TINY_SHAPES),
                head.transformer.decoder.layers[0],
                (*(torch.tensor(a) for a in args), TINY_SHAPES))
    if name == "relation_layer":
        args = (f(B, K, C), f(1, K, C), f(B, 2 * K, C), f(1, 2 * K, C))
        return (jb.RelationFusionLayerRMS(C, NH, 2048), ("relation_layer_0",), args,
                head.relation_decoder.layers[0], tuple(torch.tensor(a) for a in args))
    x = f(B, K, C)
    if name == "rmsnorm":
        return (JRMSNorm(C), ("relation_layer_0", "norm1"), (x,),
                head.relation_decoder.layers[0].norms[0], (torch.tensor(x),))
    assert name == "chunk_swiglu", name
    return (jb.ChunkSwiGLU(2048, C), ("relation_layer_0", "ffn"), (x,),
            head.relation_decoder.layers[0].ffns[0], (torch.tensor(x),))


MODULES = ["neck", "encoder_layer", "decoder_layer", "relation_layer", "rmsnorm", "chunk_swiglu"]


def _subtree(variables, path):
    tree = variables["params"]["bbox_head"]
    for p in path:
        tree = tree[p]
    return tree


def _jax_fn(jmod, jargs):
    """(f(params, *arrays) -> the module's outputs, the array arguments):
    the trailing spatial shapes stay out of the traced arguments."""
    static = tuple(a for a in jargs if isinstance(a, tuple))
    arrays = [a for a in jargs if not isinstance(a, tuple)]
    return (lambda p, *arr: jmod.apply({"params": p}, *arr, *static)), arrays


def _as_list(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _port_layout(name, got):
    """The port's outputs in JAX's layout (the neck's maps NHWC)."""
    got = _as_list(got)
    return [t.permute(0, 2, 3, 1) for t in got] if name == "neck" else got


@pytest.mark.parametrize("name", MODULES)
def test_module_matches_jax(tiny, name):
    """Each submodule on random inputs, at the tiny model's weights."""
    _, variables, _, _, port, _ = tiny
    jmod, path, jargs, pmod, pargs = _module_case(name, port, np.random.default_rng(11))
    fn, arrays = _jax_fn(jmod, jargs)
    want = _as_list(jax.jit(fn)(_subtree(variables, path), *arrays))
    with torch.no_grad():
        got = _port_layout(name, pmod(*pargs))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=MODULE_ATOL, rtol=0)


def test_swiglu_matches_jax():
    """The SwiGLU FFN (no biases: w2(silu(w1 x) * w3 x))."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 7, C)).astype(np.float32)
    jmod = JSwiGLU(48, C)
    params = perturb(numpy_init(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x), 3),
                     seed=4)["params"]
    pmod = SwiGLU(C, 48, C)
    with torch.no_grad():
        for n in ("w1", "w2", "w3"):
            getattr(pmod, n).weight.copy_(torch.tensor(params[n]["kernel"].T))
        got = pmod(torch.tensor(x)).numpy()
    want = np.asarray(jmod.apply({"params": params}, x))
    np.testing.assert_allclose(got, want, atol=MODULE_ATOL, rtol=0)


def test_forward_matches_jax(tiny):
    """Every output of the whole forward, per-layer lists included."""
    _, _, _, ref, _, out = tiny
    assert set(out) == set(ref)
    got = dict(tree_leaves(out))
    n = 0
    for k, want in tree_leaves(ref):
        if np.issubdtype(np.asarray(want).dtype, np.integer):
            np.testing.assert_array_equal(got[k], want, err_msg=k)
        else:
            assert_close_rel(got[k], want, FORWARD_ATOL, k)
        n += 1
    assert n == 17  # 13 keys and the two per-layer lists of 2 each


def test_discrete_steps_have_margin(tiny, monkeypatch):
    """The proposal top-k, the query re-rank and the pair top-k rank values
    that agree between the packages within their gap Δ; every rank of each
    step is decided by 10Δ (so JAX's picks are the port's), and the picks
    are equal."""
    _, _, images, ref, port, out = tiny
    seen = []
    orig = pb.topk_first

    def recording(x, k):
        seen.append((x.detach().numpy(), k))
        return orig(x, k)

    monkeypatch.setattr(pb, "topk_first", recording)
    with torch.no_grad():
        port(torch.tensor(images))
    assert [k for _, k in seen] == [16, 16, 12]
    # the ranked values of each step in JAX: its outputs give them (the
    # re-rank's softmax over queries is the same on the reordered logits)
    q_scores = lambda cls: jax.nn.softmax(jnp.asarray(cls), axis=1).max(-1)  # noqa: E731
    jax_values = [ref["enc_cls"][..., 0], np.asarray(q_scores(ref["cls"])),
                  ref["importance"].reshape(2, -1)]
    for (x, k), xj in zip(seen, jax_values):
        gap = np.abs(np.sort(x, -1) - np.sort(xj, -1)).max()
        for b in range(2):
            row = np.concatenate([x[b].ravel().astype(np.float64), [-np.inf]])
            assert decided_ranks(row, k, 10 * gap + 1e-7).all(), (k, b, gap)
    np.testing.assert_array_equal(out["sub_pos"], ref["sub_pos"])
    np.testing.assert_array_equal(out["obj_pos"], ref["obj_pos"])


# ---------------------------------------------------------------- losses


def test_focal_costs_and_losses_match_jax():
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(2, 9, 7)) * 2).astype(np.float32)
    labels = rng.integers(0, 7, size=(2, 5))
    got = matchers.focal_cost(torch.tensor(logits), torch.tensor(labels)).numpy()
    for b in range(2):
        want = np.asarray(j_matchers.focal_cost(jnp.asarray(logits[b]), jnp.asarray(labels[b])))
        np.testing.assert_allclose(got[b], want, rtol=LOSS_RTOL, atol=1e-7)
    x = logits.reshape(-1, 7)
    t = (rng.uniform(size=x.shape) > 0.7).astype(np.float32)
    got = float(losses.bce_focal_loss(torch.tensor(x), torch.tensor(t), 3.0))
    want = float(j_losses.bce_focal_loss(jnp.asarray(x), jnp.asarray(t), 3.0))
    assert_close_rel(got, want, LOSS_RTOL, "bce_focal_loss")
    lbl = rng.integers(-1, 7, size=x.shape[0])
    w = (lbl >= 0).astype(np.float32)
    cw = rng.uniform(0.5, 2.0, size=7).astype(np.float32)
    for class_weight in (None, cw):
        got = float(losses.multilabel_focal_loss(
            torch.tensor(x), torch.tensor(lbl), torch.tensor(w),
            None if class_weight is None else torch.tensor(class_weight)))
        want = float(j_losses.multilabel_focal_loss(
            jnp.asarray(x), jnp.asarray(lbl), jnp.asarray(w),
            None if class_weight is None else jnp.asarray(class_weight)))
        assert_close_rel(got, want, LOSS_RTOL, f"multilabel_focal_loss {class_weight is None}")


@pytest.fixture(scope="module")
def batch():
    return {k: np.asarray(v) for k, v in _tiny_bbox_batch(np.random.default_rng(1)).items()}


def test_box_assignments_equal_jax(tiny, batch):
    """box_hungarian_assign on the forward's final queries (both packages
    on the same outputs), each decoder layer's and the encoder proposals'."""
    _, _, _, ref, _, _ = tiny
    hw = batch["image_shape"].astype(np.float32)
    assign = jax.jit(jax.vmap(j_matchers.box_hungarian_assign))
    gt_cc = pb.gt_cxcywh(torch.tensor(batch["gt_boxes"]), torch.tensor(batch["image_shape"]))
    for cls, box in [(ref["cls"], ref["box"]), (ref["enc_cls"], ref["enc_box"]),
                     *zip(ref["cls_layers"], ref["box_layers"])]:
        got = matchers.box_hungarian_assign(
            torch.tensor(cls), torch.tensor(box), torch.tensor(batch["gt_labels"]), gt_cc,
            torch.tensor(batch["gt_valid"]), torch.tensor(batch["image_shape"]))
        want = assign(cls, box, batch["gt_labels"], gt_cc.numpy(), batch["gt_valid"], hw)
        np.testing.assert_array_equal(got.query2gt.numpy(), np.asarray(want.query2gt))
        np.testing.assert_array_equal(got.gt2query.numpy(), np.asarray(want.gt2query))


def _float_outputs(ref):
    return {k: v for k, v in ref.items() if k not in ("sub_pos", "obj_pos")}


def _jax_loss(kind, outputs, batch):
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if kind == "pairnet":
        losses_, cum = jb.pairnet_bbox_loss(outputs, jbatch, None, jnp.zeros((5,), jnp.float32))
        return losses_, cum
    return jb.deformable_detr_detection_loss(outputs, jbatch), None


def _port_loss(kind, outputs, batch):
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    if kind == "pairnet":
        return pb.pairnet_bbox_loss(outputs, tbatch, torch.zeros(5))
    return pb.deformable_detr_detection_loss(outputs, tbatch), None


@pytest.fixture(scope="module")
def jax_losses(tiny, batch):
    """Per loss kind: (losses, new cum, gradient w.r.t. every float output)."""
    _, _, _, ref, _, _ = tiny
    outs = jax.tree_util.tree_map(jnp.asarray, _float_outputs(ref))
    picks = {"sub_pos": ref["sub_pos"], "obj_pos": ref["obj_pos"]}
    res = {}
    for kind in ("pairnet", "detection"):
        def total(o, kind=kind):
            losses_, cum = _jax_loss(kind, {**o, **picks}, batch)
            return losses_["loss_total"], (losses_, cum)

        (_, (losses_, cum)), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(outs)
        res[kind] = (jax.tree_util.tree_map(np.asarray, losses_),
                     None if cum is None else np.asarray(cum),
                     jax.tree_util.tree_map(np.asarray, grads))
    return res


@pytest.mark.parametrize("kind", ["pairnet", "detection"])
def test_loss_matches_jax(tiny, batch, jax_losses, kind):
    """The Pair-Net losses (Seesaw counts too) and the detection-only loss on
    the same outputs."""
    _, _, _, ref, _, _ = tiny
    got, cum = _port_loss(kind, tree_torch(ref), batch)
    want, want_cum, _ = jax_losses[kind]
    assert set(got) == set(want)
    for k, v in want.items():
        assert_close_rel(float(got[k]), float(v), LOSS_RTOL, k)
    if kind == "pairnet":
        np.testing.assert_allclose(cum.numpy(), want_cum, rtol=0, atol=0)
        assert float(cum.sum()) > 0


@pytest.mark.parametrize("kind", ["pairnet", "detection"])
def test_loss_gradients_match_jax(tiny, batch, jax_losses, kind):
    """The loss's gradient with respect to every float output within
    GRAD_RTOL of the gradient's max."""
    _, _, _, ref, _, _ = tiny
    outputs = tree_torch(_float_outputs(ref), grad=True)
    full = {**outputs, "sub_pos": torch.tensor(ref["sub_pos"]),
            "obj_pos": torch.tensor(ref["obj_pos"])}
    _port_loss(kind, full, batch)[0]["loss_total"].backward()
    want = dict(tree_leaves(jax_losses[kind][2]))
    n = 0
    for k, t in tree_leaves(outputs):
        got = t.grad.numpy() if t.grad is not None else np.zeros(t.shape, np.float32)
        w = want[k]
        scale = float(np.abs(w).max(initial=0.0))
        n += scale > 0
        assert float(np.abs(got - w).max()) <= GRAD_RTOL * scale + 1e-9, (k, scale)
    assert n >= (4 if kind == "pairnet" else 6)


@pytest.mark.parametrize("name", ["neck", "encoder_layer", "decoder_layer", "relation_layer"])
def test_module_gradients_match_jax(tiny, name):
    """Each submodule on random inputs and a random cotangent: the gradient
    of every parameter within GRAD_RTOL of its max. The JAX gradients reach
    the port's names through ``load_jax_variables`` of a tree that is zero
    elsewhere."""
    _, variables, _, _, port, _ = tiny
    rng = np.random.default_rng(13)
    jmod, path, jargs, pmod, pargs = _module_case(name, port, rng)
    sub = _subtree(variables, path)
    fn, arrays = _jax_fn(jmod, jargs)
    out = jax.eval_shape(fn, sub, *arrays)
    cot = [rng.normal(size=o.shape).astype(np.float32) for o in jax.tree_util.tree_leaves(out)]
    grads = jax.jit(jax.grad(lambda p, *a: sum(jnp.sum(o * c) for o, c in zip(
        jax.tree_util.tree_leaves(fn(p, *a)), cot))))(sub, *arrays)
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    node = zeros["params"]["bbox_head"]
    for p in path[:-1]:
        node = node[p]
    node[path[-1]] = jax.tree_util.tree_map(np.asarray, grads)
    want_model = load_jax_variables(port_model(), zeros)
    prefix = {"neck": "neck", "encoder_layer": "bbox_head.transformer.encoder.layers.0",
              "decoder_layer": "bbox_head.transformer.decoder.layers.0",
              "relation_layer": "bbox_head.relation_decoder.layers.0"}[name]
    want = dict(want_model.get_submodule(prefix).named_parameters())
    pmod = copy.deepcopy(pmod)
    got_out = _port_layout(name, pmod(*pargs))
    sum((o * torch.tensor(c)).sum() for o, c in zip(got_out, cot)).backward()
    zero = 1e-5 * max(float(w.detach().abs().max()) for w in want.values())
    for n, p in pmod.named_parameters():
        w = want[n].detach().numpy()
        scale = float(np.abs(w).max())
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= GRAD_RTOL * scale + zero, (name, n, err, scale)


@pytest.mark.parametrize("b", [0, 1])
def test_postprocess_matches_jax(tiny, b):
    _, _, _, ref, _, _ = tiny
    got = pb.pairnet_bbox_postprocess(tree_torch(_float_outputs(ref)), b)
    want = jb.pairnet_bbox_postprocess(jax.tree_util.tree_map(jnp.asarray, ref), image_index=b)
    for f in ("labels", "rel_pairs", "r_labels"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    for f in ("boxes", "r_dists", "r_scores"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=1e-6, rtol=0, err_msg=f)


# ------------------------------------------------------------------ bf16


@pytest.mark.parametrize("name", MODULES)
def test_bf16_blocks_match_jax(tiny, name):
    """A bf16 forward block by block: each submodule with bf16 weights on
    bf16 inputs (the encoder's positions and every reference in f32, as the
    head hands them over) against the JAX module in bf16."""
    _, variables, _, _, port, _ = tiny
    jmod, path, jargs, pmod, pargs = _module_case(name, port, np.random.default_rng(14))
    keep_f32 = {"encoder_layer": (1, 2), "decoder_layer": (3,)}.get(name, ())

    def bf16(a, i):
        if i in keep_f32 or not isinstance(a, (np.ndarray, list, torch.Tensor)):
            return a
        if isinstance(a, list):
            return [bf16(x, -1) for x in a]
        return a.to(torch.bfloat16) if torch.is_tensor(a) else jnp.asarray(a, jnp.bfloat16)

    p16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), _subtree(variables, path))
    fn, arrays = _jax_fn(jmod, [bf16(a, i) for i, a in enumerate(jargs)])
    want = _as_list(jax.jit(fn)(p16, *arrays))
    with torch.no_grad():
        got = _port_layout(name, copy.deepcopy(pmod).to(torch.bfloat16)(
            *[bf16(a, i) for i, a in enumerate(pargs)]))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, (g.dtype, w.dtype)
        r = np.asarray(w, np.float32)
        err = float(np.abs(g.float().numpy() - r).max())
        assert err <= BF16_RTOL * np.abs(r).max(), (name, err, float(np.abs(r).max()))
