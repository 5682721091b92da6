"""Port parity: the two-stage detector's ops and neck against the JAX
package (f32, CPU): ``nms``, ``batched_nms`` and ``multiclass_nms`` (equal
keep masks, with planted score ties, boxes at IoU exactly the threshold,
invalid entries, N from 1 to 300), ``roi_align`` and
``multilevel_roi_align`` (within ``ROI_ATOL``, border and degenerate rois,
the per-level sampling bit-equal to sampling every level and picking), and
the FPN neck. The NMS kernel is held against the plain sweep on the card
in ``test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.models.necks.fpn import FPN as JFPN
from pairnet_tpu.ops import nms as j_nms
from pairnet_tpu.ops import roi_align as j_roi
from test_torch_helpers import numpy_init, perturb
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.models.necks.fpn import FPN  # noqa: E402
from pairnet_torch.ops import nms, roi_align  # noqa: E402
from pairnet_torch.ops.boxes import box_iou  # noqa: E402
from pairnet_torch.utils.from_jax import load_jax_variables  # noqa: E402

ROI_ATOL = 1e-5  # RoIAlign: bilinear taps summed in another order
NEAR = 1e-6  # an IoU this close to the threshold is a guarded decision
FPN_ATOL = 1e-4  # x max(1, |JAX|): 3x3 convs summed in another order


def nms_case(seed, n, ties=False, at_threshold=False, invalid=False):
    """Boxes (n, 4) in a 200 x 200 image and scores (n,): with ``ties``
    every third score repeats its predecessor's; with ``at_threshold``
    pairs of boxes of IoU exactly 0.5 (a 10 x 10 box and its 10 x 5 half,
    both exact in f32); with ``invalid`` a mask drops a quarter."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 160, (n, 2))
    wh = rng.uniform(4, 60, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if ties:
        scores[2::3] = scores[1::3][: len(scores[2::3])]
    if at_threshold:
        for i in range(0, n - 1, 4):
            x, y = np.floor(xy[i]).astype(np.float32)
            boxes[i] = [x, y, x + 10, y + 10]
            boxes[i + 1] = [x, y, x + 10, y + 5]
    valid = rng.random(n) > 0.25 if invalid else np.ones(n, bool)
    return boxes, scores, valid


NMS_CASES = [(1, False, False, False), (7, True, False, False), (64, False, True, False),
             (64, True, True, True), (150, False, False, True), (300, True, True, True)]


@pytest.mark.parametrize("n, ties, at_thr, invalid", NMS_CASES,
                         ids=[f"n{c[0]}-{i}" for i, c in enumerate(NMS_CASES)])
def test_nms_matches_jax(n, ties, at_thr, invalid):
    boxes, scores, valid = nms_case(n, n, ties, at_thr, invalid)
    exact = 0
    if at_thr:  # IoU exactly 0.5 is not above 0.5: both boxes are kept
        iou = box_iou(torch.tensor(boxes), torch.tensor(boxes))[0].numpy()
        exact = int((iou == np.float32(0.5)).sum())
        assert exact > 0
    want = np.asarray(j_nms.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                                jnp.asarray(valid)))
    got = nms.nms(torch.tensor(boxes), torch.tensor(scores), 0.5, torch.tensor(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    # every IoU within NEAR of the threshold is one of the planted exact ones
    iou = box_iou(torch.tensor(boxes), torch.tensor(boxes))[0].numpy()
    np.fill_diagonal(iou, -1.0)
    assert int((np.abs(iou - np.float32(0.5)) < NEAR).sum()) == exact
    assert not (got & ~valid).any()


def test_nms_batched_equals_per_image():
    """A batch of images is each image's NMS."""
    cases = [nms_case(s, 40, True, True, True) for s in range(3)]
    boxes, scores, valid = (np.stack(a) for a in zip(*cases))
    got = nms.nms(torch.tensor(boxes), torch.tensor(scores), 0.7, torch.tensor(valid)).numpy()
    for b, (bx, sc, v) in enumerate(cases):
        want = np.asarray(j_nms.nms(jnp.asarray(bx), jnp.asarray(sc), 0.7, jnp.asarray(v)))
        np.testing.assert_array_equal(got[b], want)


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_nms_matches_jax(seed):
    """The class-offset trick in f32, per image of the batch."""
    rng = np.random.default_rng(seed)
    cases = [nms_case(seed * 10 + b, 80, True, True, True) for b in range(2)]
    labels = rng.integers(0, 5, (2, 80)).astype(np.int32)
    boxes = np.stack([c[0] for c in cases])
    scores = np.stack([c[1] for c in cases])
    valid = np.stack([c[2] for c in cases])
    got = nms.batched_nms(torch.tensor(boxes), torch.tensor(scores), torch.tensor(labels), 0.5,
                          torch.tensor(valid)).numpy()
    for b in range(2):
        want = np.asarray(j_nms.batched_nms(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                                            jnp.asarray(labels[b]), 0.5, jnp.asarray(valid[b])))
        np.testing.assert_array_equal(got[b], want)
        # the offset boxes' IoUs near the threshold are the planted exact ones
        off = boxes[b] + labels[b][:, None] * (2.0 * (np.abs(boxes[b]).max() + 1.0))
        iou = box_iou(torch.tensor(off), torch.tensor(off))[0].numpy()
        np.fill_diagonal(iou, -1.0)
        near = np.abs(iou - np.float32(0.5)) < NEAR
        assert (iou[near] == np.float32(0.5)).all()


def test_multiclass_nms_matches_jax():
    boxes, _, valid = nms_case(5, 30, invalid=True)
    scores = np.random.default_rng(6).dirichlet(np.ones(4), 30).astype(np.float32)
    want = j_nms.multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.1, 0.5, 20,
                                jnp.asarray(valid))
    got = nms.multiclass_nms(torch.tensor(boxes), torch.tensor(scores), 0.1, 0.5, 20,
                             torch.tensor(valid))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_nms_plain_sweep_on_any_device_refuses_other_devices():
    """CPU tensors take the plain sweep; a device that is neither CPU nor
    CUDA raises, and the kernel is never counted here."""
    boxes, scores, valid = nms_case(0, 20)
    before = nms.nms_sorted.launches
    nms.nms(torch.tensor(boxes), torch.tensor(scores))
    assert nms.nms_sorted.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        nms.nms_sorted(torch.zeros((1, 2, 4), device="meta"), torch.ones((1, 2), dtype=bool,
                                                                           device="meta"), 0.5)


def roi_case(seed, B=2, N=24, H=24, W=32, C=5):
    """Features (B, H, W, C) at stride 4 of a 96 x 128 image and rois (B, N,
    4) in image pixels: random ones, some on and past the border, degenerate
    ones (zero width or height, a point)."""
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(B, H, W, C)).astype(np.float32)
    xy = rng.uniform(-10, 120, (B, N, 2))
    wh = rng.uniform(1, 90, (B, N, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, 0] = [0, 0, 128, 96]  # the whole image
    rois[:, 1] = [-8, -8, 4, 4]  # past the top-left corner
    rois[:, 2] = [120, 90, 140, 100]  # past the bottom-right corner
    rois[:, 3] = [30, 20, 30, 50]  # zero width
    rois[:, 4] = [40, 40, 40, 40]  # a point
    return feat, rois


@pytest.mark.parametrize("out, ratio", [(7, 2), (14, 2), (3, 1)])
def test_roi_align_matches_jax(out, ratio):
    feat, rois = roi_case(out)
    got = roi_align.roi_align(torch.tensor(feat), torch.tensor(rois), 0.25, out, ratio).numpy()
    for b in range(2):
        want = np.asarray(j_roi.roi_align(jnp.asarray(feat[b]), jnp.asarray(rois[b]), 0.25, out,
                                          ratio))
        np.testing.assert_allclose(got[b], want, atol=ROI_ATOL, rtol=0)


def multilevel_case(seed):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(2, 96 // s, 128 // s, 6)).astype(np.float32)
             for s in (4, 8, 16, 32)]
    _, rois = roi_case(seed, N=40)
    rois[:, 5:10] *= 0.2  # small rois: level 0
    rois[:, 10:25] *= 4.0  # large ones reach the coarse levels (sqrt(area) >= 112 * 2^(l-1))
    rois[:, 25:] *= 9.0
    return feats, rois


@pytest.mark.parametrize("seed", [0, 1])
def test_multilevel_roi_align_matches_jax(seed):
    feats, rois = multilevel_case(seed)
    lv = roi_align.map_rois_to_levels(torch.tensor(rois), 4).numpy()
    assert len(np.unique(lv)) >= 3
    got = roi_align.multilevel_roi_align([torch.tensor(f) for f in feats], (4, 8, 16, 32),
                                         torch.tensor(rois), 7).numpy()
    for b in range(2):
        np.testing.assert_array_equal(
            lv[b], np.asarray(j_roi.map_rois_to_levels(jnp.asarray(rois[b]), 4)))
        want = np.asarray(j_roi.multilevel_roi_align([jnp.asarray(f[b]) for f in feats],
                                                     (4, 8, 16, 32), jnp.asarray(rois[b]), 7))
        np.testing.assert_allclose(got[b], want, atol=ROI_ATOL, rtol=0)


def test_per_level_sampling_equals_sampling_every_level(monkeypatch):
    """Each roi sampled at its own level only, in chunks, is bit for bit
    the all-levels sampling followed by the pick (JAX's way), on CPU."""
    feats, rois = multilevel_case(3)
    tf = [torch.tensor(f) for f in feats]
    tr = torch.tensor(rois)
    monkeypatch.setattr(roi_align, "ROI_CHUNK", 7)  # several chunks per level
    got = roi_align.multilevel_roi_align(tf, (4, 8, 16, 32), tr, 7)
    lv = roi_align.map_rois_to_levels(tr, 4)
    every = torch.stack([roi_align.roi_align(f, tr, 1.0 / s, 7) for f, s in
                         zip(tf, (4, 8, 16, 32))])  # (L, B, N, 7, 7, C)
    picked = torch.gather(every, 0, lv[None, :, :, None, None, None].expand(
        1, *every.shape[1:]))[0]
    assert torch.equal(got, picked)


def test_fpn_matches_jax():
    """mmdet FPN over 4 levels of odd sizes (the nearest upsampling's floor
    mapping) with one extra max-pooled level."""
    rng = np.random.default_rng(0)
    chans = (8, 16, 24, 32)
    hw = ((25, 33), (13, 17), (7, 9), (4, 5))
    feats = [rng.normal(size=(2, h, w, c)).astype(np.float32) for (h, w), c in zip(hw, chans)]
    jm = JFPN(out_channels=16, num_outs=5)
    import jax

    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), feats)
    variables = perturb(numpy_init(shapes, 1), seed=2, std=0.1)
    want = jm.apply(variables, feats)
    port = load_jax_variables(FPN(chans, 16, num_outs=5),
                              {"params": {"neck": variables["params"]}}, prefix="neck.")
    with torch.no_grad():
        got = port([torch.tensor(f).permute(0, 3, 1, 2) for f in feats])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   atol=FPN_ATOL * max(1.0, np.abs(w).max()), rtol=0)
