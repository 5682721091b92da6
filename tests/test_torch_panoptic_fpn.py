"""Port parity: the two-stage sgdet detector, ``PanopticFPN``, against the
JAX package (f32, CPU) on a tiny ResNet-26 (base width 8) at 96 x 128:
anchors and box decoding, the detections (boxes within ``BOX_SCALE_TOL``,
labels, scores and valid equal), the semantic logits, the pasted mask
logits and the heuristic panoptic fusion.

Weights: JAX's flax shapes, seeded (``numpy_init`` + ``perturb``), the
box regressions scaled down so that boxes fall inside the image, and
carried over by ``load_jax_variables``. The discrete steps are guarded by
margins measured on the JAX side: the per-level top-1000 of the RPN, the
NMS IoUs against 0.7 and 0.5, the proposal and detection rankings, the
score threshold, and the fusion's ``sigmoid > 0.5``, whose flips between
the packages are counted (and must be none).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.models.backbones.resnet import ResNet as JResNet
from pairnet_tpu.models.frameworks import panoptic_fpn as j_pfpn
from test_torch_helpers import numpy_init, perturb
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.models.backbones.resnet import ResNet  # noqa: E402
from pairnet_torch.models.frameworks import panoptic_fpn  # noqa: E402
from pairnet_torch.ops.boxes import box_iou  # noqa: E402
from pairnet_torch.utils.from_jax import load_jax_variables  # noqa: E402

KW = dict(num_things=5, num_stuff=3, num_proposals=24, max_dets=8, score_thr=0.1)
HW = (96, 128)
SHAPES = np.array([[96, 128], [80, 120]], np.int32)
BOX_ULPS = 2  # decode alone: exp differs by <= 1 ulp between the packages, so a coordinate
# by a few f32 ulps of the largest value the decode handles (box_atol)
BOX_SCALE_TOL = 4e-6  # through the network: the regressions carry the convs' and RoIAlign's
# f32 summation differences; x the largest proposal coordinate (2.4e-4 px measured at ~300)
SEM_ATOL = 1e-4  # x max(1, |JAX|)
MASK_ATOL = 1e-4  # x max(1, |JAX|), on the same boxes
MARGIN = 1e-4  # the least gap at a discrete decision


@pytest.fixture(scope="module")
def detector():
    """(JAX outputs and intermediates, the port's detector, images,
    variables) of the tiny detector."""
    jd = j_pfpn.PanopticFPN(backbone=JResNet(depth=26, base_width=8), **KW)
    img = np.random.default_rng(0).normal(size=(2, *HW, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0), img, SHAPES, with_masks=True))
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                               perturb(numpy_init(shapes, 3), 4, 0.05))
    v["params"]["rpn_head"]["rpn_reg"]["kernel"] *= 0.05
    v["params"]["bbox_head"]["fc_reg"]["kernel"] *= 0.05
    v["params"]["bbox_head"]["fc_cls"]["kernel"] *= 3
    v["params"]["mask_head"]["conv_logits"]["kernel"] *= 3
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    out = jax.jit(lambda v, i, s: jd.apply(v, i, s, with_masks=True))(jv, img, SHAPES)
    # the RPN's scores and the box head's, for the margins
    fpn = jax.jit(lambda v, i: jd.apply(v, i, method=lambda m, x: m.neck(m.backbone(x))))(jv, img)
    rpn = jd.apply(jv, fpn, method=lambda m, f: m.rpn_head(f))
    port = load_jax_variables(panoptic_fpn.PanopticFPN(ResNet(depth=26, base_width=8), **KW)
                              .eval(), v)
    return {"out": out, "rpn": rpn, "port": port, "img": img, "vars": jv, "jd": jd}


def box_atol(*arrays):
    """BOX_ULPS f32 ulps at the largest magnitude of ``arrays`` (never below 1e-4 px)."""
    scale = max(float(np.abs(np.asarray(a)).max()) for a in arrays)
    return max(1e-4, BOX_ULPS * float(np.spacing(np.float32(scale))))


def test_anchors_and_decode_match_jax():
    for h, w, stride in ((3, 4, 8), (5, 7, 64)):
        np.testing.assert_array_equal(panoptic_fpn.make_anchors(h, w, stride).numpy(),
                                      np.asarray(j_pfpn.make_anchors(h, w, stride)))
    rng = np.random.default_rng(1)
    anchors = np.asarray(j_pfpn.make_anchors(4, 6, 16))
    deltas = rng.normal(0, 2, size=anchors.shape).astype(np.float32)  # some past the +-4 clip
    hw = np.array([[60, 90]], np.int32)
    want = j_pfpn.delta2bbox(jnp.asarray(anchors), jnp.asarray(deltas), stds=(0.1, 0.1, 0.2, 0.2),
                             max_hw=jnp.asarray(hw[0]))
    got = panoptic_fpn.delta2bbox(torch.tensor(anchors)[None], torch.tensor(deltas)[None],
                                  stds=(0.1, 0.1, 0.2, 0.2), max_hw=torch.tensor(hw))[0]
    unclipped = j_pfpn.delta2bbox(jnp.asarray(anchors), jnp.asarray(deltas),
                                  stds=(0.1, 0.1, 0.2, 0.2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=box_atol(unclipped), rtol=0)
    want = j_pfpn.delta2bbox(jnp.asarray(anchors), jnp.asarray(deltas))  # RPN: not clipped
    got = panoptic_fpn.delta2bbox(torch.tensor(anchors), torch.tensor(deltas))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=box_atol(want), rtol=0)


def _gap_at(scores, k):
    """The gap between the k-th and (k+1)-th largest of ``scores``."""
    s = np.sort(np.asarray(scores, np.float64).reshape(-1))[::-1]
    return np.inf if k >= len(s) else s[k - 1] - s[k]


def test_margins_of_the_discrete_steps(detector):
    """No decision of this seed lies within MARGIN: the per-level top-1000,
    the score threshold, and every IoU against the two NMS thresholds
    among the boxes that compete."""
    for cls, _ in detector["rpn"]:
        for b in range(2):
            assert _gap_at(cls[b], 1000) > MARGIN
    dets = detector["out"][0]
    scores = np.asarray(dets.scores)
    assert (np.abs(scores[np.asarray(dets.valid)] - KW["score_thr"]) > MARGIN).all()
    for b in range(2):
        boxes = torch.tensor(np.asarray(dets.boxes[b]))
        iou = box_iou(boxes, boxes)[0].numpy()
        np.fill_diagonal(iou, 0.0)
        assert (np.abs(iou - 0.5) > MARGIN).all() and (np.abs(iou - 0.7) > MARGIN).all()


def test_detections_match_jax(detector):
    dets, sem, _ = detector["out"]
    with torch.no_grad():
        got, got_sem = detector["port"](torch.tensor(detector["img"]), torch.tensor(SHAPES))
    assert np.asarray(dets.valid).sum() > 4
    assert len(np.unique(np.asarray(dets.labels))) > 2
    port = detector["port"]
    with torch.no_grad():  # the detections decode on the unclipped proposals
        props, _ = port.proposals(port.neck(port.backbone(
            torch.tensor(detector["img"]).permute(0, 3, 1, 2))), None)
    scale = float(np.abs(props.numpy()).max())
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(dets.boxes),
                               atol=max(1e-4, BOX_SCALE_TOL * scale), rtol=0)
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(dets, k)))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(dets.scores), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(dets.dists), atol=1e-6, rtol=0)
    w = np.asarray(sem)
    np.testing.assert_allclose(got_sem.numpy(), w, atol=SEM_ATOL * max(1.0, np.abs(w).max()),
                               rtol=0)


def test_proposals_match_jax(detector):
    """The RPN's proposals: per-level top-k, NMS at 0.7, the top
    ``num_proposals`` kept boxes."""
    jd, jv = detector["jd"], detector["vars"]

    def props(m, images, shapes):  # the head of JAX's __call__, up to the proposals
        fpn = m.neck(m.backbone(images))
        B = images.shape[0]
        all_s, all_b = [], []
        for (cls, reg), stride in zip(m.rpn_head(fpn), m.strides):
            h, w = cls.shape[1], cls.shape[2]
            anchors = j_pfpn.make_anchors(h, w, stride)
            s, d = cls.reshape(B, -1), reg.reshape(B, -1, 4)
            top_s, top_i = jax.lax.top_k(s, min(1000, s.shape[1]))
            all_s.append(top_s)
            all_b.append(jax.vmap(lambda dd, i: j_pfpn.delta2bbox(anchors[i], dd[i]))(d, top_i))
        s, bx = jnp.concatenate(all_s, 1), jnp.concatenate(all_b, 1)
        keep = jax.vmap(lambda b, ss: j_pfpn.nms(b, jax.nn.sigmoid(ss), 0.7))(bx, s)
        ranked = jnp.argsort(-jnp.where(keep, s, -jnp.inf), axis=1)[:, : m.num_proposals]
        take = jax.vmap(lambda a, i: a[i])
        return take(bx, ranked), take(keep, ranked)

    want_b, want_v = jax.jit(lambda v, i, s: jd.apply(v, i, s, method=props))(
        jv, detector["img"], SHAPES)
    port = detector["port"]
    with torch.no_grad():
        fpn = port.neck(port.backbone(torch.tensor(detector["img"]).permute(0, 3, 1, 2)))
        got_b, got_v = port.proposals(fpn, torch.tensor(SHAPES))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    scale = float(np.abs(np.asarray(want_b)).max())
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b),
                               atol=max(1e-4, BOX_SCALE_TOL * scale), rtol=0)


def test_pasted_masks_match_jax(detector):
    """The mask head on JAX's detections, pasted onto the stride-4 canvas."""
    dets, _, masks = detector["out"]
    port = detector["port"]
    tdets = panoptic_fpn.Detections(*(torch.tensor(np.asarray(t)) for t in dets))
    with torch.no_grad():
        fpn = port.neck(port.backbone(torch.tensor(detector["img"]).permute(0, 3, 1, 2)))
        got = port.paste_masks([f.permute(0, 2, 3, 1) for f in fpn], tdets, (24, 32))
    w = np.asarray(masks)
    assert (w > 0).mean() > 0.02 and (w == -1e4).any()
    np.testing.assert_allclose(got.numpy(), w, atol=MASK_ATOL * max(1.0, np.abs(w[w > -1e4]).max()),
                               rtol=0)


def test_heuristic_fusion_matches_jax(detector):
    """JAX's and the port's fusion on JAX's detector outputs: equal
    segments. The ``sigmoid > 0.5`` of the port's own pasted masks flips
    at no pixel against JAX's (and no logit lies within MARGIN of 0)."""
    dets, sem, masks = detector["out"]
    want = j_pfpn.heuristic_fusion_segments(dets, masks, sem, KW["num_things"], KW["num_stuff"])
    tdets = panoptic_fpn.Detections(*(torch.tensor(np.asarray(t)) for t in dets))
    got = panoptic_fpn.heuristic_fusion_segments(tdets, torch.tensor(np.asarray(masks)),
                                                 torch.tensor(np.asarray(sem)), KW["num_things"],
                                                 KW["num_stuff"])
    for k in want._fields:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert np.asarray(want.valid).sum() >= 3
    with torch.no_grad():
        _, _, port_masks = detector["port"](torch.tensor(detector["img"]), torch.tensor(SHAPES),
                                            with_masks=True)
    w = np.asarray(masks)
    flips = ((port_masks.numpy() > 0) != (w > 0)).sum()
    assert flips == 0 and (np.abs(w) > MARGIN).all()
