"""Port parity: the two-stage relation heads against the JAX package (f32,
CPU): MOTIFS, IMP, GPS-Net and VCTree in predcls, sgcls and sgdet at a tiny
width (hidden 32, roi 64, pooling 96, embed 16, 8 classes, 6 predicates,
N = 7 objects, 12 pairs, FPN features of 16 channels at 64 x 96).

The heads take the same FPN features and batch; every weight is seeded
(``numpy_init`` + ``perturb``, BatchNorm variances kept positive) and
carried over by ``load_jax_variables``. Checked: the outputs
(``refine_scores``, ``rel_scores``, ``obj_preds``, VCTree's
``relatedness``) within ``ATOL`` of each output's max, the losses within
``LOSS_RTOL``, every parameter's gradient within ``GRAD_RTOL`` of its max,
the post-processed rankings equal; the label decoders' argmax feedback,
the samplers, the VCTree builder and the rankers; and that every BatchNorm
keeps its running statistics in ``train()``.

sgcls and sgdet batches carry the same detector-like ``det_dists`` for both
packages (what a detector's box classifier gives), sgdet batches a
validity that is not a prefix (as the fused segments'). Without
``det_dists`` JAX's MOTIFS, GPS-Net and VCTree heads fail outside predcls
and the port's raise; IMP reads none in either package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.models.heads.twostage import contexts as j_ctx
from pairnet_tpu.models.heads.twostage import core as j_core
from pairnet_tpu.models.heads.twostage import heads as j_heads
from pairnet_tpu.models.heads.twostage import ranker as j_ranker
from pairnet_tpu.models.heads.twostage import vctree as j_vctree
from test_torch_helpers import numpy_init, perturb
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.models.heads.twostage import contexts, core, ranker, vctree  # noqa: E402
from pairnet_torch.models.heads.twostage import heads  # noqa: E402
from pairnet_torch.utils.from_jax import load_jax_variables, port_arrays  # noqa: E402

C, R, N, P = 8, 6, 7, 12
HW = (64, 96)
KW = dict(num_classes=C, num_predicates=R, hidden_dim=32, roi_dim=64, context_pooling_dim=96,
          embed_dim=16, in_channels=16, use_bias=True)
ATOL = 1e-4  # outputs: x max(1, max |JAX|) of each
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4  # x the max |JAX gradient| of each parameter
MARGIN = 1e-4  # the least top-2 gap of an argmax that feeds a later decision
HEADS = {"MotifHead": (j_heads.MotifHead, heads.MotifHead),
         "IMPHead": (j_heads.IMPHead, heads.IMPHead),
         "GPSHead": (j_heads.GPSHead, heads.GPSHead),
         "VCTreeHead": (j_vctree.VCTreeHead, vctree.VCTreeHead)}
MODES = ("predcls", "sgcls", "sgdet")


def make_batch(mode, seed=0, B=2):
    rng = np.random.default_rng(seed)
    H, W = HW
    x0, y0 = rng.uniform(0, W - 24, (B, N)), rng.uniform(0, H - 24, (B, N))
    boxes = np.stack([x0, y0, x0 + rng.uniform(4, 30, (B, N)), y0 + rng.uniform(4, 30, (B, N))],
                     -1).astype(np.float32)
    valid = np.arange(N)[None] < np.array([[N], [N - 2]])
    if mode == "sgdet":  # fused segments: not a prefix
        valid = rng.random((B, N)) < 0.75
        valid[:, :2] = True
    labels = np.where(valid, rng.integers(1, C, (B, N)), 0).astype(np.int32)
    ordered = np.stack(np.nonzero(~np.eye(N, dtype=bool)), -1)
    pairs = np.stack([ordered[rng.permutation(len(ordered))[:P]] for _ in range(B)]).astype(
        np.int32)
    batch = dict(det_boxes=boxes, det_labels=labels, det_valid=valid, pairs=pairs,
                 pair_valid=rng.random((B, P)) < 0.8,
                 pair_labels=rng.integers(0, R, (B, P)).astype(np.int32),
                 image_shape=np.array([[H, W]] * B, np.int32))
    if mode != "predcls":
        batch["det_dists"] = rng.dirichlet(np.ones(C), (B, N)).astype(np.float32)
    return batch


def fpn_feats(seed=1, B=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, HW[0] // s, HW[1] // s, 16)).astype(np.float32)
            for s in (4, 8, 16, 32)]


def seeded_variables(shapes, seed):
    """numpy_init + perturb; BatchNorm variances positive."""
    v = perturb(numpy_init(shapes, seed), seed + 1, 0.05)

    def fix(t, name=""):
        if isinstance(t, dict):
            return {k: fix(x, k) for k, x in t.items()}
        return np.asarray(np.abs(t) + 0.5 if name == "var" else t, np.float32)

    return fix(v)


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


_cases = {}


def _jax_total(out, jb):
    losses = j_heads.twostage_loss(out, jb)
    if "relatedness" in out:
        losses["loss_total"] = losses["loss_total"] + j_vctree.vctree_binary_loss(
            out["relatedness"], jb)
    return losses["loss_total"]


def case(head, mode):
    """JAX's head, variables, outputs (and, in predcls, its gradients of the
    total loss); the port's head and outputs."""
    if (head, mode) not in _cases:
        jcls, pcls = HEADS[head]
        batch, feats = make_batch(mode), fpn_feats()
        jh = jcls(mode=mode, **KW)
        jb = jax_batch(batch)
        shapes = jax.eval_shape(jh.init, jax.random.PRNGKey(0), feats, jb)
        v = seeded_variables(shapes, 3)
        jv = jax.tree_util.tree_map(jnp.asarray, v)
        jgrad = None
        if mode == "predcls":  # the outputs and the gradients in one pass
            def total(params):
                out = jh.apply({**jv, "params": params}, feats, jb)
                return _jax_total(out, jb), out

            (_, out), jgrad = jax.value_and_grad(total, has_aux=True)(jv["params"])
        else:
            out = jh.apply(jv, feats, jb)
        want = {k: np.asarray(x) for k, x in out.items()}
        port = load_jax_variables(pcls(mode=mode, **KW).eval(),
                                  {c: {"relation_head": v[c]} for c in v}, prefix="relation_head.")
        with torch.no_grad():
            got = port([torch.tensor(f) for f in feats], tb(batch))
        _cases[head, mode] = dict(jh=jh, jv=jv, v=v, batch=batch, jb=jb, feats=feats, want=want,
                                  jgrad=jgrad, port=port,
                                  got={k: x.numpy() for k, x in got.items()})
    return _cases[head, mode]


def top2_gap(scores, valid):
    s = np.sort(np.asarray(scores, np.float64)[..., 1:], -1)
    return (s[..., -1] - s[..., -2])[valid].min()


CASES = [(h, m) for h in HEADS for m in MODES]


@pytest.mark.parametrize("head, mode", CASES, ids=[f"{h}-{m}" for h, m in CASES])
def test_head_matches_jax(head, mode):
    c = case(head, mode)
    want, got = c["want"], c["got"]
    assert set(got) == set(want)
    if mode != "predcls":  # argmax picks (decoders, IMP / GPS predictions) are decided
        assert top2_gap(want["refine_scores"], c["batch"]["det_valid"]) > MARGIN
    for k in want:
        if k == "obj_preds":
            np.testing.assert_array_equal(got[k], want[k])
        else:
            scale = max(1.0, float(np.abs(want[k]).max()))
            np.testing.assert_allclose(got[k], want[k], atol=ATOL * scale, rtol=0, err_msg=k)


@pytest.mark.parametrize("head, mode", [(h, m) for h in HEADS for m in MODES[1:]],
                         ids=[f"{h}-{m}" for h in HEADS for m in MODES[1:]])
def test_heads_without_det_dists(head, mode):
    """Outside predcls a batch without ``det_dists``: JAX's MOTIFS, GPS-Net
    and VCTree heads fail and the port's raise; IMP, which reads none,
    gives the same outputs as with them."""
    c = case(head, mode)
    batch = {k: v for k, v in c["batch"].items() if k != "det_dists"}
    feats = [torch.tensor(f) for f in c["feats"]]
    if head == "IMPHead":
        with torch.no_grad():
            got = c["port"](feats, tb(batch))
        for k, v in c["got"].items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        return
    with pytest.raises(TypeError):
        c["jh"].apply(c["jv"], c["feats"], jax_batch(batch))
    with pytest.raises(ValueError, match="det_dists"):
        c["port"](feats, tb(batch))


def _losses(mod, outputs, batch):
    losses = dict(mod.twostage_loss(outputs, batch))
    if "relatedness" in outputs:
        losses["loss_tree"] = mod.vctree_binary_loss(outputs["relatedness"], batch)
    return losses


@pytest.mark.parametrize("head, mode", CASES, ids=[f"{h}-{m}" for h, m in CASES])
def test_losses_match_jax(head, mode):
    c = case(head, mode)
    jmod = type("J", (), {"twostage_loss": staticmethod(j_heads.twostage_loss),
                          "vctree_binary_loss": staticmethod(j_vctree.vctree_binary_loss)})
    pmod = type("P", (), {"twostage_loss": staticmethod(heads.twostage_loss),
                          "vctree_binary_loss": staticmethod(vctree.vctree_binary_loss)})
    want = _losses(jmod, {k: jnp.asarray(v) for k, v in c["want"].items()}, c["jb"])
    got = _losses(pmod, {k: torch.tensor(v) for k, v in c["got"].items()}, tb(c["batch"]))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("head", list(HEADS))
def test_gradients_match_jax(head):
    """Every parameter's gradient of the total loss (predcls)."""
    c = case(head, "predcls")
    want = port_arrays(c["port"], {"params": {"relation_head": jax.tree_util.tree_map(
        np.asarray, c["jgrad"])}}, prefix="relation_head.")
    port = c["port"]
    port.zero_grad()
    out = port([torch.tensor(f) for f in c["feats"]], tb(c["batch"]))
    losses = heads.twostage_loss(out, tb(c["batch"]))
    loss = losses["loss_total"]
    if "relatedness" in out:
        loss = loss + vctree.vctree_binary_loss(out["relatedness"], tb(c["batch"]))
    loss.backward()
    for name, p in port.named_parameters():
        w = want[name]
        if "bias_hh" in name:  # the JAX cell has one summed bias: the port's two get its gradient
            ih = want[name.replace("bias_hh", "bias_ih")]
            H3 = 2 * len(ih) // 3  # a GRU's r and z chunks get it; its n chunk is its own
            w = ih if "_l0" in name else np.concatenate([ih[:H3], w[H3:]])
        scale = max(float(np.abs(w).max()), 1e-12)
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(w)
        np.testing.assert_allclose(g, w, atol=GRAD_RTOL * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("head, mode", [("MotifHead", "sgdet"), ("VCTreeHead", "predcls"),
                                        ("GPSHead", "sgcls")])
def test_postprocess_rankings_match_jax(head, mode):
    c = case(head, mode)
    for b in range(2):
        want = j_heads.twostage_postprocess(c["want"], c["jb"], b)
        got = heads.twostage_postprocess({k: torch.tensor(v) for k, v in c["got"].items()},
                                         tb(c["batch"]), b)
        prs = want["rel_pair_idxes"]
        trip = want["rel_dists"].max(-1) * want["obj_scores"][prs[:, 0]] * want["obj_scores"][
            prs[:, 1]]
        assert len(prs) > 3 and (-np.diff(trip)).min() > 1e-6  # no near-tie in the ranking
        np.testing.assert_array_equal(got["rel_pair_idxes"], want["rel_pair_idxes"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_allclose(got["rel_dists"], want["rel_dists"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["obj_scores"], want["obj_scores"], atol=1e-5, rtol=0)


def test_decoder_argmax_feedback_matches_jax():
    """The MOTIFS decoder without teacher forcing: each step's argmax is
    embedded into the next step's input."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, N, 24)).astype(np.float32)
    mask = np.arange(N)[None] < np.array([[N], [4]])
    jm = j_ctx.DecoderRNN(C, 16, 32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, mask)
    v = seeded_variables(shapes, 6)
    v["params"]["step"]["out_obj"]["kernel"] *= 4  # spread the logits
    want_d, want_p = jm.apply(jax.tree_util.tree_map(jnp.asarray, v), x, mask)
    want_d, want_p = np.asarray(want_d), np.asarray(want_p)
    assert top2_gap(want_d, mask) > MARGIN
    assert len(np.unique(want_p[mask])) > 2
    port = load_jax_variables(contexts.DecoderRNN(C, 24, 16, 32),
                              {c: {"relation_head": {"context_layer": {"decoder_rnn": v[c]}}}
                               for c in v}, prefix="relation_head.context_layer.decoder_rnn.")
    with torch.no_grad():
        got_d, got_p = port(torch.tensor(x), torch.tensor(mask))
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_allclose(got_d.numpy(), want_d, atol=ATOL * max(1, np.abs(want_d).max()),
                               rtol=0)


@pytest.mark.parametrize("n_valid, cap", [(5, 16), (7, 8), (0, 8)])
def test_sample_train_pairs_match_jax(n_valid, cap):
    rng = np.random.default_rng(n_valid)
    relmap = np.where(rng.random((N, N)) < 0.3, rng.integers(1, R, (N, N)), 0)
    np.fill_diagonal(relmap, 0)
    want = j_core.sample_train_pairs(relmap, n_valid, cap, rng=np.random.default_rng(9))
    got = core.sample_train_pairs(relmap, n_valid, cap, rng=np.random.default_rng(9))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_valid, max_n", [(3, 5), (0, 4), (8, 8)])
def test_all_test_pairs_match_jax(n_valid, max_n):
    for g, w in zip(core.all_test_pairs(n_valid, max_n), j_core.all_test_pairs(n_valid, max_n)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("require_overlap", [False, True])
def test_detect_relsample_matches_jax(require_overlap):
    b = make_batch("sgdet", seed=4)
    det_boxes, det_labels = b["det_boxes"][0], b["det_labels"][0]
    gt_boxes = det_boxes[[0, 2, 3, 5]] + 1.0
    gt_labels = det_labels[[0, 2, 3, 5]]
    relmap = np.zeros((4, 4), np.int64)
    relmap[0, 1], relmap[2, 3], relmap[1, 2] = 3, 1, 2
    args = (det_boxes, det_labels, gt_boxes, gt_labels, relmap, 10)
    want = j_core.detect_relsample(*args, require_overlap=require_overlap,
                                   rng=np.random.default_rng(2))
    got = core.detect_relsample(*args, require_overlap=require_overlap,
                                rng=np.random.default_rng(2))
    assert want[1].max() > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_gen_vctree_binary_chain():
    """A chain 0 -> 1 -> 2 -> 3: each node the first child of the one
    before; an invalid node stays out of the tree."""
    s = np.full((5, 5), 0.1, np.float32)
    for i in range(3):
        s[i, i + 1] = 0.9
    s[0, :] += 0.5  # node 0 has the highest row mean: the root
    valid = np.array([True, True, True, True, False])
    want = j_vctree.gen_vctree_binary(jnp.asarray(s), jnp.asarray(valid))
    got = vctree.gen_vctree_binary(torch.tensor(s)[None], torch.tensor(valid)[None])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    assert list(np.asarray(want[2])) == [-1, 0, 1, 2, -1]


def test_gen_vctree_binary_random_scores():
    rng = np.random.default_rng(3)
    s = rng.random((3, 9, 9)).astype(np.float32)
    valid = rng.random((3, 9)) < 0.8
    valid[:, 0] = True
    got = vctree.gen_vctree_binary(torch.tensor(s), torch.tensor(valid))
    depth = vctree.tree_depths(got[2])
    for b in range(3):
        want = j_vctree.gen_vctree_binary(jnp.asarray(s[b]), jnp.asarray(valid[b]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
        np.testing.assert_array_equal(depth[b].numpy(),
                                      np.asarray(j_vctree.tree_depths(want[2])))


def test_rankers_match_jax():
    rng = np.random.default_rng(8)
    u = rng.normal(size=(2, P, 24)).astype(np.float32)
    ub = np.abs(rng.normal(50, 20, size=(2, P, 4))).astype(np.float32)
    ub[..., 2:] += ub[..., :2]
    pv = rng.random((2, P)) < 0.7
    for jm, pm, args in ((j_ranker.LinearRanker(16, 2), ranker.LinearRanker(24, 16, 2), (u, pv)),
                         (j_ranker.LSTMRanker(16), ranker.LSTMRanker(24, 16), (u, ub, pv))):
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)
        v = seeded_variables(shapes, 2)
        want = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, v), *args))
        port = load_jax_variables(pm, v)
        with torch.no_grad():
            got = port(*(torch.tensor(a) for a in args)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL * max(1, np.abs(want[pv]).max()), rtol=0)
    sal = rng.random((30, 40)).astype(np.float32)
    boxes = np.array([[2, 3, 20, 25], [10.5, 0, 39, 29], [5, 5, 5, 5]], np.float32)
    pairs = np.array([[0, 1], [1, 2], [2, 0], [0, 2]], np.int32)
    pvalid = np.array([True, True, False, True])
    want = np.asarray(j_ranker.get_weak_key_rel_labels(*map(jnp.asarray, (sal, boxes, pairs,
                                                                          pvalid))))
    got = ranker.get_weak_key_rel_labels(*map(torch.tensor, (sal, boxes, pairs, pvalid)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_batchnorm_stays_frozen_in_train_mode():
    """Every BatchNorm of the heads reads its running statistics in
    ``train()`` too (JAX's ``use_running_average=True``): the forward equals
    eval's, and an optimizer step moves the affine but no statistic."""
    c = case("VCTreeHead", "sgcls")
    port = c["port"]
    bns = [m for m in port.modules() if isinstance(m, core.RunningBatchNorm)]
    assert len(bns) == 5  # pos_bn, box_bn, overlap_bn, the union rects' bn1 and bn2
    stats = {n: b.clone() for n, b in port.named_buffers()}
    port.train()
    try:
        out = port([torch.tensor(f) for f in c["feats"]], tb(c["batch"]))
        np.testing.assert_allclose(out["rel_scores"].detach().numpy(), c["got"]["rel_scores"],
                                   atol=1e-6, rtol=0)
        opt = torch.optim.SGD(port.parameters(), lr=0.1)
        before = bns[0].weight.detach().clone()
        heads.twostage_loss(out, tb(c["batch"]))["loss_total"].backward()
        opt.step()
        assert not torch.equal(bns[0].weight, before)
        for n, b in port.named_buffers():
            assert torch.equal(b, stats[n]), n
    finally:
        _cases.pop(("VCTreeHead", "sgcls"))  # its weights moved
