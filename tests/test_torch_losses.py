"""Port parity: losses, matching costs, assigners and point sampling of
``pairnet_torch`` against the JAX package (f32, CPU), on the same numpy
inputs. Losses and costs agree within rel 1e-6 (the same f32 formulas,
summed in another order); assignments agree exactly on costs whose optimum
is decided by a margin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.models import losses as jl
from pairnet_tpu.models import matchers as jm
from pairnet_tpu.ops import sampling as js
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.models import losses as tl  # noqa: E402
from pairnet_torch.models import matchers as tm  # noqa: E402
from pairnet_torch.ops import sampling as ts  # noqa: E402

RTOL = 1e-6
T = torch.tensor


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    N, C, P = 40, 9, 64
    labels = rng.integers(-1, C, size=N)  # -1: padded slots
    return {
        "logits": (rng.normal(size=(N, C)) * 3).astype(np.float32),
        "labels": labels,
        "weights": (labels >= 0).astype(np.float32),
        "class_weight": rng.uniform(0.1, 1.0, size=C).astype(np.float32),
        "cum": rng.integers(0, 50, size=C).astype(np.float32),
        "pts_logits": (rng.normal(size=(N, P)) * 2).astype(np.float32),
        "pts_target": (rng.uniform(size=(N, P)) > 0.6).astype(np.float32),
        "importance": rng.normal(size=(3, 12, 12)).astype(np.float32),
        "imp_target": (rng.uniform(size=(3, 12, 12)) > 0.9).astype(np.float32),
    }


@pytest.mark.parametrize("class_weight", [False, True])
def test_softmax_ce(data, class_weight):
    cw = data["class_weight"] if class_weight else None
    want = jl.softmax_ce(jnp.asarray(data["logits"]), jnp.asarray(data["labels"]),
                         jnp.asarray(data["weights"]), None if cw is None else jnp.asarray(cw))
    got = tl.softmax_ce(T(data["logits"]), T(data["labels"]), T(data["weights"]),
                        None if cw is None else T(cw))
    _close(got, want)


@pytest.mark.parametrize("cum", ["zeros", "counts"])
def test_seesaw_ce_and_counts(data, cum):
    """The loss, its gradient (the compensation reads detached scores) and
    the running counts, updated before the weights."""
    c0 = np.zeros_like(data["cum"]) if cum == "zeros" else data["cum"]
    args = (data["labels"], data["weights"], c0)

    def j_loss(x):
        return jl.seesaw_ce(x, *map(jnp.asarray, args))

    (want, want_cum), want_grad = jax.value_and_grad(j_loss, has_aux=True)(
        jnp.asarray(data["logits"]))
    x = T(data["logits"], requires_grad=True)
    got, got_cum = tl.seesaw_ce(x, *map(T, args))
    got.backward()
    _close(got, want)
    _close(got_cum, want_cum)
    _close(x.grad, want_grad)
    assert float(got_cum.sum()) == float(c0.sum() + data["weights"].sum())


def test_bce_with_logits_pos_weight(data):
    npos = max(data["imp_target"].sum(), 1.0)
    pw = data["imp_target"].size / npos
    want = jl.bce_with_logits_pos_weight(jnp.asarray(data["importance"]),
                                         jnp.asarray(data["imp_target"]), pw)
    _close(tl.bce_with_logits_pos_weight(T(data["importance"]), T(data["imp_target"]), pw), want)


def test_sigmoid_bce_and_dice(data):
    x, t, w = data["pts_logits"], data["pts_target"], data["weights"]
    _close(tl.sigmoid_bce(T(x), T(t)), jl.sigmoid_bce(jnp.asarray(x), jnp.asarray(t)))
    _close(tl.naive_dice_loss(T(x), T(t), T(w)),
           jl.naive_dice_loss(jnp.asarray(x), jnp.asarray(t), jnp.asarray(w)))


def test_costs(data):
    """The three mask-matching costs, batched (B = 2) against the JAX
    functions vmapped over images."""
    rng = np.random.default_rng(1)
    B, Q, G, C, P = 2, 10, 6, 9, 64
    logits = (rng.normal(size=(B, Q, C)) * 2).astype(np.float32)
    gt_labels = rng.integers(0, C, size=(B, G))
    pred = (rng.normal(size=(B, Q, P)) * 2).astype(np.float32)
    gt = (rng.uniform(size=(B, G, P)) > 0.5).astype(np.float32)
    _close(tm.classification_cost(T(logits), T(gt_labels)),
           jax.vmap(jm.classification_cost)(jnp.asarray(logits), jnp.asarray(gt_labels)))
    _close(tm.bce_mask_cost(T(pred), T(gt)),
           jax.vmap(jm.bce_mask_cost)(jnp.asarray(pred), jnp.asarray(gt)))
    _close(tm.dice_cost(T(pred), T(gt)), jax.vmap(jm.dice_cost)(jnp.asarray(pred), jnp.asarray(gt)))


def test_point_sample_and_mask_points():
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(2, 9, 13, 5)).astype(np.float32)
    pts = rng.uniform(-0.2, 1.2, size=(2, 7, 3, 2)).astype(np.float32)
    _close(ts.point_sample(T(feat), T(pts)),
           js.point_sample_batched(jnp.asarray(feat), jnp.asarray(pts)))
    masks = rng.normal(size=(2, 4, 9, 13)).astype(np.float32)
    mpts = rng.uniform(size=(2, 30, 2)).astype(np.float32)
    _close(ts.sample_mask_points(T(masks), T(mpts)),
           jax.vmap(js.sample_mask_points)(jnp.asarray(masks), jnp.asarray(mpts)))
    pred, gt_pts = tm.sample_points_for_matching(T(masks), T(masks > 0), T(mpts))
    j_pred, j_gt = jax.vmap(jm.sample_points_for_matching)(
        jnp.asarray(masks), jnp.asarray(masks > 0), jnp.asarray(mpts))
    _close(pred, j_pred)
    _close(gt_pts, j_gt)


def _owners(rng, B, n, m):
    """For each of B problems, m distinct rows out of n: the row planted to
    win each column by a margin."""
    return np.stack([rng.permutation(n)[:m] for _ in range(B)])


def test_mask_hungarian_assign():
    rng = np.random.default_rng(3)
    B, Q, G, C, P = 2, 12, 5, 8, 96
    gt_labels = np.stack([rng.permutation(C)[:G] for _ in range(B)])
    gt_pts = (rng.uniform(size=(B, G, P)) > 0.5).astype(np.float32)
    gt_valid = np.ones((B, G), bool)
    gt_valid[1, -2:] = False
    # each valid GT has one query with its class and its mask (by a margin)
    owner = _owners(rng, B, Q, G)
    cls = rng.normal(size=(B, Q, C + 1)).astype(np.float32)
    pred = rng.normal(size=(B, Q, P)).astype(np.float32)
    for b in range(B):
        for g in range(G):
            cls[b, owner[b, g], gt_labels[b, g]] += 8.0
            pred[b, owner[b, g]] = (gt_pts[b, g] * 2 - 1) * 6.0
    got = tm.mask_hungarian_assign(T(cls), T(pred), T(gt_labels), T(gt_pts), T(gt_valid))
    want = jax.vmap(jm.mask_hungarian_assign)(
        jnp.asarray(cls), jnp.asarray(pred), jnp.asarray(gt_labels), jnp.asarray(gt_pts),
        jnp.asarray(gt_valid))
    np.testing.assert_array_equal(got.query2gt.numpy(), np.asarray(want.query2gt))
    np.testing.assert_array_equal(got.gt2query.numpy(), np.asarray(want.gt2query))
    np.testing.assert_array_equal(got.gt2query[0].numpy(), owner[0])
    assert (got.gt2query[1, -2:] == -1).all()


def test_id_match():
    rng = np.random.default_rng(4)
    B, K, C, R, Rm = 2, 10, 6, 5, 4
    # distinct subject classes: no two relations tie for a query
    gt_sub = np.stack([rng.permutation(C)[:Rm] for _ in range(B)])
    gt_obj = rng.integers(0, C, size=(B, Rm))
    rel_valid = np.ones((B, Rm), bool)
    rel_valid[0, -1] = False
    owner = _owners(rng, B, K, Rm)
    sub = rng.normal(size=(B, K, C + 1)).astype(np.float32)
    obj = rng.normal(size=(B, K, C + 1)).astype(np.float32)
    for b in range(B):
        for r in range(Rm):
            sub[b, owner[b, r], gt_sub[b, r]] += 8.0
            obj[b, owner[b, r], gt_obj[b, r]] += 8.0
    rel = rng.normal(size=(B, K, R)).astype(np.float32)
    labels = rng.integers(0, R, size=(B, Rm))
    args = (sub, obj, rel, gt_sub, gt_obj, labels, rel_valid)
    got = tm.id_match(*map(T, args))
    want = jax.vmap(jm.id_match)(*map(jnp.asarray, args))
    np.testing.assert_array_equal(got.relq2gt.numpy(), np.asarray(want.relq2gt))
    np.testing.assert_array_equal(got.gt2relq.numpy(), np.asarray(want.gt2relq))
    np.testing.assert_array_equal(got.gt2relq[1].numpy(), owner[1])
