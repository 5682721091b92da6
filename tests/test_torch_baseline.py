"""Port parity: the Mask2Former baselines (PSGFormer+ with and without
Seesaw, MyPSGFormer) and PSGTr2 of ``pairnet_torch`` against the JAX
package (f32, CPU), and the Mask2Former decoder's reference route.

Tiny widths as the JAX package's own tests (20 object / 16 relation
queries for the baselines, 12 for PSGTr2, width 32, 4 heads, 3 decoder
layers, 1 pixel-decoder layer) on ResNet-26 at base width 8, landscape
2x64x96 images, every weight with seeded noise, carried over by
``load_jax_variables``. The baselines build their decoder with
``return_intermediate``, so it takes the reference route (full-resolution
prediction heads after every layer, resized to the next level); PSGTr2's
takes the resize-then-contract route. Forward outputs within ``ATOL`` x
max(1, |JAX|), the sigmoid < 0.5 attention masks held by their margin;
losses and their gradients on the same outputs and points handed to both
packages; Hungarian assignments, Seesaw counts and post-processed triplets
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.models.heads import baseline_head as j_base
from pairnet_tpu.models.heads import psgtr2_head as j_psgtr2
from pairnet_tpu.models.matchers import classification_cost as j_cls_cost
from pairnet_tpu.models.matchers import mask_hungarian_assign as j_mask_assign
from pairnet_tpu.models.matchers import sample_points_for_matching as j_sample_match
from pairnet_tpu.ops.hungarian import hungarian as j_hungarian
from pairnet_tpu.ops.sampling import sample_mask_points as j_sample
from pairnet_tpu.utils.torch_convert import convert_baseline_checkpoint
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

from pairnet_torch.models import matchers  # noqa: E402
from pairnet_torch.models.decoders import mask2former_decoder  # noqa: E402
from pairnet_torch.models.heads import baseline_head, psgtr2_head  # noqa: E402
from pairnet_torch.models.layers import MLP  # noqa: E402
from pairnet_torch.models.necks.pixel_decoder import bilinear_resize  # noqa: E402
from pairnet_torch.ops import hungarian as hungarian_mod  # noqa: E402
from pairnet_torch.utils.from_jax import _leaves, port_arrays  # noqa: E402

ATOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
NUM_POINTS = 96
M2F = dict(num_heads=4, num_decoder_layers=3, pixel_decoder_layers=1, embed_dims=32)
BASE = dict(num_classes=7, num_relations=5, num_obj_query=20, num_rel_query=16,
            num_relation_layers=2, **M2F)
HEADS = {
    "baseline": (j_base.BaselineHead, baseline_head.BaselineHead, BASE),
    "mypsgformer": (j_base.MyPSGFormerHead, baseline_head.MyPSGFormerHead, BASE),
    "psgtr2": (j_psgtr2.PSGTr2Head, psgtr2_head.PSGTr2Head,
               dict(num_classes=7, num_relations=5, num_query=12, **M2F)),
}


@pytest.fixture(scope="module")
def batch():
    return zoo_batch(seed=1)


@pytest.fixture(scope="module")
def pairs(batch):
    """Per head: (JAX model, variables, JAX outputs, port model, port outputs)."""
    return {name: zoo_pair(jh, ph, kw, batch["image"]) for name, (jh, ph, kw) in HEADS.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items() if k != "image"}


def _tbatch(batch):
    return tree_torch({k: v for k, v in batch.items() if k != "image"})


def _points(batch):
    """The points JAX's losses draw from key 0, handed to the port."""
    B = batch["image"].shape[0]
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (B, NUM_POINTS, 2)))


def _float_outputs(ref):
    return {k: v for k, v in ref.items()
            if isinstance(v, (dict, list)) or not np.issubdtype(np.asarray(v).dtype, np.integer)}


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("name", list(HEADS))
def test_forward_matches_jax(pairs, name):
    """Every output (the baselines' per-layer cls and mask lists included)
    within ATOL x max(1, |JAX|); the prototype-matched indices equal where
    their top-2 gap is above the tolerance."""
    _, _, ref, _, out = pairs[name]
    want, got = dict(tree_leaves(ref)), dict(tree_leaves(out))
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


def _reference_route_logits(port, images):
    """The attention-mask logits the baseline decoder consumed on the
    reference route: the prediction head's full-resolution logits before
    the first layer and after every layer but the last, each resized to the
    level of the layer that reads it. (B, Q, h*w) each."""
    head = port.bbox_head
    dec = head.transformer_decoder
    seen = {}
    hooks = [head.pixel_decoder.register_forward_hook(lambda m, i, o: seen.update(pix=o)),
             dec.register_forward_hook(lambda m, i, o: seen.update(dec=o))]
    with torch.no_grad():
        port(torch.tensor(images))
        for h in hooks:
            h.remove()
        mask_features, ms_feats = seen["pix"]
        q0 = head.query_feat.weight[None].expand(images.shape[0], -1, -1)
        _, m0, _ = dec.forward_head(q0, mask_features.float(), (1, 1), head.cls_embed,
                                    head.mask_embed)
        masks = [m0] + [m for _, m in seen["dec"]["intermediates"][:-1]]
        return [bilinear_resize(m, ms_feats[i % len(ms_feats)].shape[-2:]).flatten(2).numpy()
                for i, m in enumerate(masks)]


@pytest.mark.parametrize("name", ["baseline", "mypsgformer"])
def test_reference_route_attention_masks_have_margin(pairs, batch, name):
    """The sigmoid < 0.5 attention masks of the reference route are decided
    far from their boundary: every consumed logit is further from 0 than
    10x the largest gap between the two packages' per-layer mask logits,
    so no mask bit can differ."""
    _, _, ref, port, out = pairs[name]
    gap = max(float(np.abs(o - r).max()) for o, r in zip(out["mask_layers"], ref["mask_layers"]))
    margin = min(float(np.abs(am).min()) for am in _reference_route_logits(port, batch["image"]))
    assert margin > 10 * gap, (margin, gap)


def test_decoder_routes_differ_only_by_reassociation(pairs, batch):
    """The baseline's decoder on the default route (resize, then contract)
    gives the reference route's final logits up to f32 reassociation, and
    keeps no intermediates; Pair-Net's decoder is built on that route."""
    port = pairs["baseline"][3]
    dec = port.bbox_head.transformer_decoder
    assert dec.return_intermediate
    with torch.no_grad():
        ref_route = port(torch.tensor(batch["image"]))
        dec.return_intermediate = False
        try:
            fast = port(torch.tensor(batch["image"]))
        finally:
            dec.return_intermediate = True
    assert fast["cls_layers"] == [] and len(ref_route["cls_layers"]) == 3
    assert_close_rel(fast["mask"].numpy(), ref_route["mask"].numpy(), ATOL)
    assert not mask2former_decoder.Mask2FormerDecoder().return_intermediate


def test_converter_closure(pairs, batch):
    """``convert_baseline_checkpoint`` takes the port's ``state_dict()``: it
    reads every key, gives back every leaf bit for bit, and JAX's forward on
    what it gives equals the port's."""
    jm, variables, _, port, out = pairs["baseline"]

    class Tracked(dict):
        read = set()

        def __getitem__(self, k):
            self.read.add(k)
            return dict.__getitem__(self, k)

    sd = Tracked({k: v.numpy() for k, v in port.state_dict().items()})
    back = convert_baseline_checkpoint(sd)
    assert set(sd) == sd.read, sorted(set(sd) - sd.read)
    for col in ("params", "constants"):
        want, got = dict(_leaves(variables[col])), dict(_leaves(back[col]))
        assert set(want) == set(got), sorted(set(want) ^ set(got))
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg="/".join(k))
    ref = jax.jit(jm.apply)(back, batch["image"])
    for k in ("mask", "rel", "subject_scores"):
        assert_close_rel(out[k], np.asarray(ref[k]), ATOL, k)


# ------------------------------------------------------------------ training


class Recorder:
    """Wraps ``batched_hungarian`` of a module: keeps each call's row2col."""

    def __init__(self, module, monkeypatch):
        self.calls = []
        orig = module.batched_hungarian

        def rec(cost, row_mask=None, col_mask=None):
            res = orig(cost, row_mask, col_mask)
            self.calls.append(res[0].numpy())
            return res

        monkeypatch.setattr(module, "batched_hungarian", rec)


def _j_baseline_assign(ref, batch, points):
    """JAX's per-layer mask assignment (L + 1, B, Q) over its loss's layer
    list, and the OldIdMatcher's relq2gt (B, K) on the last."""
    jb = _jbatch(batch)
    G = batch["gt_labels"].shape[1]
    layers = list(zip(ref["cls_layers"] + [ref["cls"]], ref["mask_layers"] + [ref["mask"]]))

    def mask_single(cls, mask, labels, masks, valid, pts):
        mpts, gpts = j_sample_match(mask, masks, pts)
        a = j_mask_assign(cls, mpts, labels, gpts, valid)
        return a.query2gt, a.gt2query

    per = [jax.vmap(mask_single)(c, m, jb["gt_labels"], jb["gt_masks"], jb["gt_valid"],
                                 jnp.asarray(points)) for c, m in layers]

    def rel(sub_s, obj_s, rel_s, g2q, rels, rv):
        sub_gt = jnp.clip(rels[:, 0], 0, G - 1)
        obj_gt = jnp.clip(rels[:, 1], 0, G - 1)
        ok = rv & (g2q[sub_gt] >= 0) & (g2q[obj_gt] >= 0)
        cost = (j_cls_cost(sub_s, jnp.where(ok, g2q[sub_gt], 0))
                + j_cls_cost(obj_s, jnp.where(ok, g2q[obj_gt], 0))
                + j_cls_cost(rel_s, rels[:, 2]))
        return j_hungarian(cost, col_mask=ok)[0]

    relq2gt = jax.vmap(rel)(ref["subject_scores"], ref["object_scores"], ref["rel"], per[-1][1],
                            jb["gt_rels"], jb["rel_valid"])
    return np.stack([np.asarray(q) for q, _ in per]), np.asarray(relq2gt)


def _j_psgtr2_assign(ref, batch, points):
    """JAX's MaskHTriMatcher: relq2gt (B, Q)."""
    jb = _jbatch(batch)
    G = batch["gt_labels"].shape[1]

    def single(s_c, o_c, r_c, s_seg, o_seg, labels, masks, rels, rv, pts):
        sub_gt = jnp.clip(rels[:, 0], 0, G - 1)
        obj_gt = jnp.clip(rels[:, 1], 0, G - 1)
        s_pts, gt_pts = j_sample_match(s_seg, masks, pts)
        o_pts = j_sample(o_seg, pts)
        return j_psgtr2.mask_htri_match(s_c, o_c, r_c, s_pts, o_pts, gt_pts[sub_gt],
                                        gt_pts[obj_gt], labels[sub_gt], labels[obj_gt],
                                        rels[:, 2], rv)

    return np.asarray(jax.vmap(single)(
        ref["sub"], ref["obj"], ref["rel"], ref["sub_seg"], ref["obj_seg"], jb["gt_labels"],
        jb["gt_masks"], jb["gt_rels"], jb["rel_valid"], jnp.asarray(points)))


CUM = np.arange(6, dtype=np.float32) * 3.0  # Seesaw counts over R + 1 classes


def _port_loss(case, outputs, batch):
    points = torch.tensor(_points(batch))
    if case == "psgtr2":
        return psgtr2_head.psgtr2_loss(outputs, _tbatch(batch), points, num_classes=7), None
    seesaw = case == "seesaw"
    return baseline_head.baseline_loss(outputs, _tbatch(batch), points,
                                       torch.tensor(CUM) if seesaw else None, use_seesaw=seesaw)


def _jax_loss(case, outputs, batch):
    jb = _jbatch(batch)
    key = jax.random.PRNGKey(0)
    if case == "psgtr2":
        return j_psgtr2.psgtr2_loss(outputs, jb, key, num_classes=7, num_points=NUM_POINTS), None
    if case == "seesaw":
        return j_base.baseline_loss(outputs, jb, key, num_points=NUM_POINTS, use_seesaw=True,
                                    cum_samples=jnp.asarray(CUM))
    return j_base.baseline_loss(outputs, jb, key, num_points=NUM_POINTS), None


CASES = {"baseline": "baseline", "seesaw": "baseline", "psgtr2": "psgtr2"}


@pytest.fixture(scope="module")
def jax_losses(pairs, batch):
    """Per case: JAX's losses, Seesaw counts, and the gradient of its total
    with respect to every float output."""
    res = {}
    for case, head in CASES.items():
        ref = _float_outputs(pairs[head][2])

        def total(o, case=case):
            losses, cum = _jax_loss(case, o, batch)
            return losses["loss_total"], (losses, cum)

        (_, (losses, cum)), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, ref))
        res[case] = ({k: float(v) for k, v in losses.items()},
                     None if cum is None else np.asarray(cum),
                     jax.tree_util.tree_map(np.asarray, grads))
    return res


@pytest.mark.parametrize("case", ["baseline", "psgtr2"])
def test_hungarian_matches_jax(pairs, batch, monkeypatch, case):
    """On JAX's outputs and points, every assignment equals JAX's. The
    baseline solves every layer's mask assignment (L + 1 layers: JAX's
    loss appends the final layer to the decoder's intermediates, which hold
    it already) in one call and the triplet assignment in a second; PSGTr2
    its triplet assignment in one."""
    ref = pairs[case][2]
    module = baseline_head if case == "baseline" else psgtr2_head
    rec = Recorder(module, monkeypatch)
    rec_masks = Recorder(matchers, monkeypatch)
    _port_loss(case, tree_torch(_float_outputs(ref)), batch)
    B = batch["image"].shape[0]
    points = _points(batch)
    if case == "baseline":
        want_masks, want_rel = _j_baseline_assign(ref, batch, points)
        assert len(rec_masks.calls) == 1 and len(rec.calls) == 1
        np.testing.assert_array_equal(rec_masks.calls[0].reshape(-1, B, want_masks.shape[-1]),
                                      want_masks)
        np.testing.assert_array_equal(rec.calls[0], want_rel)
        assert (want_masks >= 0).any() and (want_rel >= 0).any()
    else:
        want = _j_psgtr2_assign(ref, batch, points)
        assert len(rec.calls) == 1 and not rec_masks.calls
        np.testing.assert_array_equal(rec.calls[0], want)
        assert (want >= 0).any()


@pytest.mark.parametrize("case", list(CASES))
def test_loss_matches_jax(pairs, batch, jax_losses, case):
    """The same outputs and points to both packages: every loss term within
    LOSS_RTOL; the Seesaw counts equal."""
    ref = _float_outputs(pairs[CASES[case]][2])
    want, want_cum, _ = jax_losses[case]
    losses, cum = _port_loss(case, tree_torch(ref), batch)
    got = {k: float(v) for k, v in losses.items()}
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, w in want.items():
        assert abs(got[k] - w) <= LOSS_RTOL * abs(w) + 1e-7, (k, got[k], w)
    if case == "seesaw":
        np.testing.assert_array_equal(cum.numpy(), want_cum)
        assert (want_cum > CUM).any()


@pytest.mark.parametrize("case", list(CASES))
def test_loss_gradients_match_jax(pairs, batch, jax_losses, case):
    """The gradient of the total loss with respect to every output within
    GRAD_RTOL of its max."""
    ref = _float_outputs(pairs[CASES[case]][2])
    outputs = tree_torch(ref, grad=True)
    _port_loss(case, outputs, batch)[0]["loss_total"].backward()
    want = dict(tree_leaves(jax_losses[case][2]))
    n = 0
    for k, t in tree_leaves(outputs):
        if not t.is_floating_point():
            continue
        got = t.grad.numpy() if t.grad is not None else np.zeros(t.shape, np.float32)
        scale = float(np.abs(want[k]).max(initial=0.0))
        n += scale > 0
        assert float(np.abs(got - want[k]).max()) <= GRAD_RTOL * scale + 1e-9, (k, scale)
    assert n >= 4


class _DecoderHost(torch.nn.Module):
    """The reference-route decoder with the tables its head owns, under the
    head's names."""

    def __init__(self, C, heads, layers, num_classes, Q, levels):
        super().__init__()
        self.transformer_decoder = mask2former_decoder.Mask2FormerDecoder(
            C, heads, layers, return_intermediate=True)
        self.query_feat = torch.nn.Embedding(Q, C)
        self.query_embed = torch.nn.Embedding(Q, C)
        self.level_embed = torch.nn.Embedding(levels, C)
        self.cls_embed = torch.nn.Linear(C, num_classes + 1)
        self.mask_embed = MLP(C, C, C, 3)

    def forward(self, feats, mf, pos):
        return self.transformer_decoder(feats, mf, pos, self.query_feat.weight,
                                        self.query_embed.weight, self.level_embed.weight,
                                        self.cls_embed, self.mask_embed)


def test_reference_route_decoder_gradients_match_jax():
    """The decoder on its reference route, alone, on random features and a
    random cotangent on every layer's (cls, mask) and the queries: every
    parameter's and input's gradient within GRAD_RTOL of its max (a
    gradient that is 0 up to rounding within 1e-5 of the largest), with its
    attention masks decided by a margin."""
    from pairnet_tpu.models.decoders.mask2former_decoder import Mask2FormerDecoder

    rng = np.random.default_rng(7)
    C, heads, L, Q, ncls = 32, 4, 3, 10, 7
    shapes = ((2, 3), (4, 6), (8, 12))
    feats = [rng.normal(size=(2, h, w, C)).astype(np.float32) for h, w in shapes]
    mf = rng.normal(size=(2, 16, 24, C)).astype(np.float32)
    pos = [rng.normal(size=(h, w, C)).astype(np.float32) for h, w in shapes]
    jdec = Mask2FormerDecoder(num_classes=ncls, num_queries=Q, embed_dims=C, num_heads=heads,
                              num_layers=L, out_channels=C, return_intermediate=True)
    sh = jax.eval_shape(jdec.init, jax.random.PRNGKey(0), feats, mf, pos)
    params = perturb(numpy_init(sh, 8), seed=9, std=0.05)["params"]

    def run(p, feats, mf, pos):
        o = jdec.apply({"params": p}, feats, mf, pos)
        return [x for pair in o["intermediates"] for x in pair] + [o["queries"]]

    out = jax.eval_shape(run, params, feats, mf, pos)
    cot = [rng.normal(size=o.shape).astype(np.float32) for o in out]
    grads = jax.jit(lambda *a: jax.vjp(run, *a)[1](cot))(params, feats, mf, pos)
    host = _DecoderHost(C, heads, L, ncls, Q, 3)
    nested = lambda tree: {"bbox_head": {"transformer_decoder": tree}}  # noqa: E731
    arrays = port_arrays(host, {"params": nested(dict(params))}, "bbox_head.")
    host.load_state_dict({k: torch.tensor(a) for k, a in arrays.items()})
    tf = [torch.tensor(f).permute(0, 3, 1, 2).requires_grad_() for f in feats]
    tmf = torch.tensor(mf).permute(0, 3, 1, 2).requires_grad_()
    o = host(tf, tmf, [torch.tensor(p) for p in pos])
    got = [x for pair in o["intermediates"] for x in pair] + [o["queries"]]
    for g, w in zip(got, jax.jit(run)(params, feats, mf, pos)):
        assert_close_rel(g.detach().numpy(), np.asarray(w), ATOL)
    # the attention masks read the resized mask logits: held by their margin
    gap = max(float(np.abs(g.detach().numpy() - np.asarray(w)).max())
              for g, w in zip(got[1:-1:2], jax.jit(run)(params, feats, mf, pos)[1:-1:2]))
    margin = min(float(np.abs(bilinear_resize(m.detach(), shapes[(i + 1) % 3]).numpy()).min())
                 for i, m in enumerate(got[1:-1:2][:-1]))
    assert margin > 10 * gap, (margin, gap)
    sum((g * torch.tensor(c)).sum() for g, c in zip(got, cot)).backward()
    want = port_arrays(host, {"params": nested(jax.tree_util.tree_map(np.asarray, grads[0]))},
                       "bbox_head.")
    zero = 1e-5 * max(float(np.abs(w).max()) for w in want.values())
    for n, p in host.named_parameters():
        scale = float(np.abs(want[n]).max())
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        if scale <= zero:
            assert float(np.abs(g).max()) <= zero, n
        else:
            assert float(np.abs(g - want[n]).max()) <= GRAD_RTOL * scale, n
    for t, w in zip(tf, grads[1]):
        assert_close_rel(t.grad.permute(0, 2, 3, 1).numpy(), np.asarray(w), GRAD_RTOL, "feats")
    assert_close_rel(tmf.grad.permute(0, 2, 3, 1).numpy(), np.asarray(grads[2]), GRAD_RTOL, "mf")


# ------------------------------------------------------------------ inference


def _confident(tree, keys, peak=20.0):
    return {k: (v * (peak / np.abs(v).max()) if k in keys else v) for k, v in tree.items()
            if not isinstance(v, (dict, list))}


@pytest.mark.parametrize("name, b", [(n, b) for n in ("baseline", "psgtr2") for b in (0, 1)])
def test_postprocess_matches_jax(pairs, name, b):
    """The same outputs to both post-processings (class logits scaled, so
    the fusion keeps segments): labels, ranked predicates, masks and the
    panoptic map equal, every top-k rank decided by a margin."""
    ref = pairs[name][2]
    out = _confident(ref, ("cls", "sub", "obj"))
    j_post = j_base.baseline_postprocess if name == "baseline" else j_psgtr2.psgtr2_postprocess
    t_post = (baseline_head.baseline_postprocess if name == "baseline"
              else psgtr2_head.psgtr2_postprocess)
    j = j_post({k: jnp.asarray(v) for k, v in out.items()}, b, 4)
    t = t_post(tree_torch(out), b, 4)
    probs = np.asarray(jax.nn.softmax(out["rel"][b], -1))[:, 1:].ravel()
    assert decided_ranks(probs, out["rel"].shape[1], 1e-6).all()
    for field in ("labels", "rel_pairs", "masks", "pan_seg", "r_labels"):
        np.testing.assert_array_equal(getattr(t, field).numpy(), np.asarray(getattr(j, field)),
                                      err_msg=field)
    for field in ("r_scores", "r_dists"):
        np.testing.assert_allclose(getattr(t, field).numpy(), np.asarray(getattr(j, field)),
                                   atol=1e-6, rtol=0, err_msg=field)
    assert len(np.unique(np.asarray(j.pan_seg))) > 1


def test_hungarian_launches_once_per_matcher(pairs, batch, monkeypatch):
    """The baseline's loss reaches the solver twice whatever its layer
    count: once for every (layer, image) mask problem, once for the
    triplets."""
    calls = []
    orig = hungarian_mod._solve_n_le_m
    monkeypatch.setattr(hungarian_mod, "_solve_n_le_m", lambda c: calls.append(c.shape) or orig(c))
    _port_loss("baseline", tree_torch(_float_outputs(pairs["baseline"][2])), batch)
    B, Q = batch["image"].shape[0], BASE["num_obj_query"]
    assert calls == [((BASE["num_decoder_layers"] + 1) * B, batch["gt_labels"].shape[1], Q),
                     (B, batch["gt_rels"].shape[1], BASE["num_rel_query"])]
