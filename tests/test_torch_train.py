"""Port parity: the Pair-Net training step of ``pairnet_torch`` against the
JAX package's (f32, CPU), on the tiny flagship.

Both packages are built with ``relation_ffn_drop=0.0``, so no dropout
stream has to match, and load the same noised weights. Images are 2x64x96.
The mask-cost sampling points of a step are the JAX step's own
(``jax.random.uniform`` on its points key), handed to the port. The GT
segments are the port's own predicted masks of distinct queries, with their
predicted classes, so the Hungarian assignment is decided by a wide margin
and both packages build the same targets; the class embedding is scaled
up so that the triplet assignment is decided too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from __graft_entry__ import _flagship
from pairnet_tpu.models.heads.pairnet_loss import pairnet_loss as j_pairnet_loss
from pairnet_tpu.models.heads.pairnet_loss import pairnet_targets as j_pairnet_targets
from pairnet_tpu.train.optim import build_optimizer as j_build_optimizer
from pairnet_tpu.train.optim import lr_mult_tree as j_lr_mult_tree
from pairnet_tpu.train.optim import norm_free_decay_mask as j_decay_mask
from pairnet_tpu.train.trainer import TrainState as JTrainState
from pairnet_tpu.train.trainer import make_train_step as j_make_train_step
from test_torch_helpers import perturb
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.flagship import flagship  # noqa: E402
from pairnet_torch.models.heads.pairnet_loss import pairnet_loss, pairnet_targets  # noqa: E402
from pairnet_torch.train import trainer as trainer_mod  # noqa: E402
from pairnet_torch.train.optim import (  # noqa: E402
    DEFAULT_LR_KEYS,
    build_optimizer,
    lr_mult_tree,
    norm_free_decay_mask,
    step_lr_schedule,
)
from pairnet_torch.train.trainer import TrainState, Trainer, make_train_step  # noqa: E402
from pairnet_torch.utils.from_jax import (  # noqa: E402
    _leaves,
    load_jax_train_state,
    load_jax_variables,
    port_arrays,
)

B, H, W = 2, 64, 96
G, R = 6, 8  # padded GT segments and relations
NUM_POINTS = 64
NUM_REL = 5  # the tiny model's predicates
LR = 1e-4


def _jax_model():
    jm = _flagship(tiny=True)
    return jm.clone(bbox_head=jm.bbox_head.clone(relation_ffn_drop=0.0))


def _port(variables):
    return load_jax_variables(flagship(tiny=True, device="cpu", relation_ffn_drop=0.0), variables)


def _gt(rng, C, valid_segments):
    """Distinct labels of G segments and R relations with distinct
    (subject, object) pairs among the valid segments, so no two GT columns
    of an assignment tie."""
    labels = np.stack([rng.permutation(C)[:G] for _ in range(B)])
    pairs = np.stack([rng.permutation(valid_segments ** 2)[:R] for _ in range(B)])
    rels = np.stack([pairs // valid_segments, pairs % valid_segments,
                     rng.integers(1, NUM_REL + 1, (B, R))], -1)
    return labels.astype(np.int32), rels.astype(np.int32)


def _batch(port, images, seed=0):
    """GT masks from the port's own predictions, the masks of distinct
    queries, so the mask assignment is decided by a wide margin; G - 1
    valid segments and R - 2 valid relations among them."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        out = port.eval()(torch.tensor(images))
    Q, C = out["cls"].shape[1], out["cls"].shape[2] - 1
    q = np.stack([rng.permutation(Q)[:G] for _ in range(B)])
    masks = out["mask"].numpy()[np.arange(B)[:, None], q] > 0
    labels, rels = _gt(rng, C, G - 1)
    return {"image": images, "gt_labels": labels, "gt_masks": masks,
            "gt_valid": np.arange(G)[None].repeat(B, 0) < G - 1, "gt_rels": rels,
            "rel_valid": np.arange(R)[None].repeat(B, 0) < R - 2}


def _port_batch(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


def _step_points(jstate):
    """The points of the JAX step from ``jstate`` (its second key)."""
    _, points_rng, _ = jax.random.split(jstate.rng, 3)
    return np.asarray(jax.random.uniform(points_rng, (B, NUM_POINTS, 2)))


def _port_step(model, state, batch, points, monkeypatch, **kw):
    monkeypatch.setattr(trainer_mod, "sample_points", lambda *a: torch.tensor(points))
    step = make_train_step(model, state.optimizer, {"num_points": NUM_POINTS}, **kw)
    return {k: float(v) for k, v in step(state, _port_batch(batch)).items()}


@pytest.fixture(scope="module")
def setup():
    """The JAX state before and after one step, its metrics, the points of
    both of its steps, the batch, and the weights."""
    images = np.random.default_rng(0).normal(size=(B, H, W, 3)).astype(np.float32)
    jm = _jax_model()
    variables = perturb(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3))), seed=2,
                        std=0.05)
    # sharper class predictions: near-uniform ones leave the triplet
    # assignment of 6 relations to 16 queries with near-ties at 1e-6
    variables["params"]["bbox_head"]["transformer_decoder"]["cls_embed"]["kernel"] *= 4
    batch = _batch(_port(variables), images)
    tx = j_build_optimizer(variables["params"], base_lr=LR)
    state0 = JTrainState.create(variables, tx, NUM_REL)
    step = jax.jit(j_make_train_step(jm, tx, {"num_points": NUM_POINTS}))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state1, m1 = step(state0, jbatch)
    state2, m2 = step(state1, jbatch)
    return {
        "variables": variables, "batch": batch, "state0": state0, "state1": state1,
        "state2": state2, "m1": jax.device_get(m1), "m2": jax.device_get(m2),
        "points1": _step_points(state0), "points2": _step_points(state1),
    }


def _port_state(variables):
    model = _port(variables)
    opt = build_optimizer(model, base_lr=LR)
    return model, TrainState(model, opt, NUM_REL)


def _jax_params(model, state):
    """The JAX state's params as port arrays."""
    return port_arrays(model, {"params": jax.device_get(state.params["params"])})


def _check_metrics(got, want, rtol=1e-4):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], float(v), rtol=rtol, atol=1e-6, err_msg=k)


def test_pairnet_loss_matches_jax():
    """Targets and losses, segmentation losses included, on random head
    outputs handed to both packages with the same points."""
    rng = np.random.default_rng(5)
    Q, K, C, h, w = 12, 8, 7, 16, 24
    out = {
        "cls": rng.normal(size=(B, Q, C + 1)) * 2, "mask": rng.normal(size=(B, Q, h, w)) * 3,
        "rel": rng.normal(size=(B, K, NUM_REL)), "importance": rng.normal(size=(B, Q, Q)),
        "sub": rng.normal(size=(B, K, C + 1)) * 2, "obj": rng.normal(size=(B, K, C + 1)) * 2,
    }
    out = {k: v.astype(np.float32) for k, v in out.items()}
    q = np.stack([rng.permutation(Q)[:G] for _ in range(B)])
    labels, rels = _gt(rng, C, G - 1)
    batch = {
        "gt_labels": labels,
        "gt_masks": (out["mask"][np.arange(B)[:, None], q] > 0).astype(np.float32),
        "gt_valid": np.arange(G)[None].repeat(B, 0) < G - 1, "gt_rels": rels,
        "rel_valid": np.arange(R)[None].repeat(B, 0) < R - 1,
    }
    points = rng.uniform(size=(B, NUM_POINTS, 2)).astype(np.float32)
    cum = rng.integers(0, 9, NUM_REL).astype(np.float32)
    jout = {k: jnp.asarray(v) for k, v in out.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jt = j_pairnet_targets(jout, jb, jnp.asarray(points))
    # JAX draws its points from a key; the port takes them: hand both the same
    key = jax.random.PRNGKey(3)
    jpoints = np.asarray(jax.random.uniform(key, (B, NUM_POINTS, 2)))
    jl, jcum = j_pairnet_loss(jout, jb, key, jnp.asarray(cum), num_points=NUM_POINTS,
                              with_seg_losses=True)
    tout = {k: torch.tensor(v) for k, v in out.items()}
    tb = _port_batch(batch)
    tt = pairnet_targets(tout, tb, torch.tensor(points))
    for name in ("r_labels", "r_weights", "sub_ids", "obj_ids", "gt_importance", "query2gt"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)),
                                      err_msg=name)
    assert float(tt.r_weights.sum()) > 0 and float(tt.gt_importance.sum()) > 0
    tl, tcum = pairnet_loss(tout, tb, torch.tensor(jpoints), torch.tensor(cum),
                            with_seg_losses=True)
    _check_metrics({k: float(v) for k, v in tl.items()}, jax.device_get(jl), rtol=1e-5)
    np.testing.assert_array_equal(tcum.numpy(), np.asarray(jcum))


def test_lr_mults_and_decay_mask_match_jax(setup):
    """Leaf for leaf, through the weight bridge's name map; cls_embed and
    the other decoder tables train at 0.1, as under flax's
    transformer_decoder scope."""
    params = setup["variables"]["params"]
    model = _port(setup["variables"])
    j_mults = j_lr_mult_tree(params, DEFAULT_LR_KEYS)
    j_mask = j_decay_mask(params)
    def as_arrays(tree):  # each leaf's value over its parameter's shape
        filled = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), m, np.float32),
                                        tree, params)
        return port_arrays(model, {"params": filled})

    want_mult, want_mask = as_arrays(j_mults), as_arrays(j_mask)
    got_mult = lr_mult_tree(model, DEFAULT_LR_KEYS)
    got_mask = norm_free_decay_mask(model)
    assert set(got_mult) == set(want_mult) == set(got_mask)
    for name in got_mult:
        # a packed in_proj takes one value from three equal leaves
        assert np.all(want_mult[name] == got_mult[name]), name
        assert np.all(want_mask[name] == float(got_mask[name])), name
    for name in ("cls_embed.weight", "query_feat.weight", "level_embed.weight",
                 "mask_embed.0.weight"):
        assert got_mult[f"bbox_head.{name}"] == 0.1, name
    assert got_mult["backbone.conv1.weight"] == 0.0
    assert got_mult["bbox_head.rel_cls_embed.weight"] == 1.0


def test_step_lr_schedule():
    sched = step_lr_schedule(1e-4, steps_per_epoch=10, decay_epochs=(5, 10))
    assert [sched(s) for s in (0, 49, 50, 99, 100)] == [1e-4, 1e-4, 5e-5, 5e-5, 2.5e-5]


@pytest.fixture(scope="module")
def port_step1(setup):
    """The port's first step from the same weights and points."""
    model, state = _port_state(setup["variables"])
    mp = pytest.MonkeyPatch()
    try:
        metrics = _port_step(model, state, setup["batch"], setup["points1"], mp)
    finally:
        mp.undo()
    return model, state, metrics


def test_train_step_losses_and_grad_norm_match_jax(setup, port_step1):
    _, state, metrics = port_step1
    _check_metrics(metrics, setup["m1"])
    assert state.step == 1
    np.testing.assert_array_equal(state.cum_samples.numpy(),
                                  np.asarray(setup["state1"].cum_samples))
    assert float(state.cum_samples.sum()) > 0


def test_train_step_gradients_match_jax(setup, port_step1):
    """The clipped gradients; JAX's are read back from its first Adam
    moment, mu = (1 - b1) g. All of them together agree within 1e-4 in L2
    norm. Leaf by leaf within 2e-3 x max|ref| (+1e-9 for the leaves whose
    gradient is 0 but for rounding, the conv biases before a GroupNorm):
    a ReLU whose input lies within f32 noise of 0 passes gradient in one
    package and not in the other, which moves the weight gradient of the
    layer before it by up to ~2e-3 of its largest entry."""
    model, _, _ = port_step1
    adam = setup["state1"].opt_state[1][0]
    want = port_arrays(model, {"params": jax.device_get(adam.mu)})
    diff2 = ref2 = 0.0
    for name, p in model.named_parameters():
        ref = want[name] / 0.1
        got = p.grad.numpy()
        np.testing.assert_allclose(got, ref, atol=2e-3 * np.abs(ref).max() + 1e-9, rtol=0,
                                   err_msg=name)
        diff2 += float(np.sum((got.astype(np.float64) - ref) ** 2))
        ref2 += float(np.sum(ref.astype(np.float64) ** 2))
    assert ref2 > 0 and diff2 ** 0.5 <= 1e-4 * ref2 ** 0.5, (diff2 ** 0.5, ref2 ** 0.5)


def test_train_step_parameters_match_jax(setup, port_step1):
    """The parameters after the AdamW step. Adam's first step is
    lr * g / (|g| + eps): a gradient error d moves it by at most
    lr * 2d / (|g| + eps), so leaves whose gradient is near 0 may differ by
    up to 2 lr; elsewhere the steps agree closely."""
    model, _, _ = port_step1
    adam = setup["state1"].opt_state[1][0]
    g_ref = port_arrays(model, {"params": jax.device_get(adam.mu)})
    before = port_arrays(model, {"params": jax.device_get(setup["state0"].params["params"])})
    after = _jax_params(model, setup["state1"])
    mults = lr_mult_tree(model, DEFAULT_LR_KEYS)
    for name, p in model.named_parameters():
        g_j = g_ref[name] / 0.1
        d = np.abs(p.grad.numpy() - g_j)
        lr = LR * mults[name]
        # plus two f32 ulps of the parameter for the rounding of p + step
        tol = lr * np.minimum(2.0, 1e-3 + 2 * d / (np.abs(g_j) + 1e-8)) \
            + 2 * np.spacing(np.abs(after[name]))
        np.testing.assert_array_less(np.abs(p.detach().numpy() - after[name]), tol, err_msg=name)
        if mults[name] == 0.0:  # the frozen stem does not move
            np.testing.assert_array_equal(p.detach().numpy(), before[name], err_msg=name)


def test_second_step_from_loaded_jax_state(setup, monkeypatch):
    """``load_jax_train_state`` carries the JAX state after one step (params,
    Adam moments and count, step, Seesaw counts) into the port; a second
    step from it matches JAX's second step."""
    model, state = _port_state(setup["variables"])
    load_jax_train_state(state, setup["state1"])
    assert state.step == 1
    adam = setup["state1"].opt_state[1][0]
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = port_arrays(model, {"params": jax.device_get(tree)})
        for name, p in model.named_parameters():
            np.testing.assert_array_equal(state.optimizer.state[p][key].numpy(), want[name])
    metrics = _port_step(model, state, setup["batch"], setup["points2"], monkeypatch)
    _check_metrics(metrics, setup["m2"])
    np.testing.assert_array_equal(state.cum_samples.numpy(),
                                  np.asarray(setup["state2"].cum_samples))
    # Adam's second step is lr * m / (sqrt(v) + eps) with the bias-corrected
    # moments m, v; from the same loaded moments, a gradient error d moves
    # m by d/1.9 and sqrt(v) by at most 0.71 d, so the step by at most
    # ~1.24 lr d / sqrt(v) (|m| / sqrt(v) <= 1.002): the first step's limit
    # with sqrt(v) in place of |g|, d read from the two first moments
    adam2 = setup["state2"].opt_state[1][0]
    mu2 = port_arrays(model, {"params": jax.device_get(adam2.mu)})
    nu2 = port_arrays(model, {"params": jax.device_get(adam2.nu)})
    after = _jax_params(model, setup["state2"])
    mults = lr_mult_tree(model, DEFAULT_LR_KEYS)
    for name, p in model.named_parameters():
        moments = state.optimizer.state[p]
        assert int(moments["step"]) == 2, name
        d = np.abs(moments["exp_avg"].numpy().astype(np.float64) - mu2[name]) / 0.1
        v_hat = np.sqrt(nu2[name].astype(np.float64) / (1 - 0.999 ** 2))
        lr = LR * mults[name]
        tol = lr * np.minimum(2.0, 1e-3 + 2 * d / (v_hat + 1e-8)) \
            + 2 * np.spacing(np.abs(after[name]))
        np.testing.assert_array_less(np.abs(p.detach().numpy() - after[name]), tol, err_msg=name)


def test_sub_obj_class_losses_train_nothing(setup):
    """The head detaches the class and mask predictions it gathers for the
    pairs (JAX stops their gradient), so loss_sub_cls + loss_obj_cls has
    gradient exactly 0 with respect to every parameter."""
    model = _port(setup["variables"]).train()
    batch = _port_batch(setup["batch"])
    batch["gt_masks"] = batch["gt_masks"].float()
    losses, _ = pairnet_loss(model(batch["image"]), batch, torch.tensor(setup["points1"]),
                             torch.zeros(NUM_REL))
    assert float(losses["loss_sub_cls"]) > 0
    params = list(model.parameters())
    target = losses["loss_sub_cls"] + losses["loss_obj_cls"] + 0.0 * losses["loss_match"]
    grads = torch.autograd.grad(target, params, allow_unused=True)
    assert all(g is None or not g.any() for g in grads)


def test_bf16_compute_step(setup, port_step1, monkeypatch):
    """compute_dtype=bf16: the forward runs on bf16 copies, the masters and
    the optimizer state stay f32, and the loss tracks the f32 step's (the
    bound of the JAX package's own bf16 test)."""
    model, state = _port_state(setup["variables"])
    m16 = _port_step(model, state, setup["batch"], setup["points1"], monkeypatch,
                     compute_dtype=torch.bfloat16)
    m32 = port_step1[2]
    assert np.isfinite(m16["loss_total"]) and m16["grad_norm"] > 0
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    for s in state.optimizer.state.values():
        assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
    assert abs(m16["loss_total"] - m32["loss_total"]) < 0.15 * abs(m32["loss_total"]) + 0.5


def test_trainer_fit_and_resume(setup, tmp_path):
    """One epoch of two batches on a step LR schedule, with a val pass and
    a checkpoint, then a new Trainer resumes from it: the same step,
    weights, Adam state and generator."""
    model, state = _port_state(setup["variables"])
    # the lr halves after the first step
    kw = {"loss_kwargs": {"num_points": NUM_POINTS}, "log_interval": 1,
          "schedule": step_lr_schedule(LR, steps_per_epoch=1, decay_epochs=(1,))}
    trainer = Trainer(state, str(tmp_path), **kw)
    batches = [setup["batch"], setup["batch"]]
    hooked = []
    last = trainer.fit(lambda epoch: batches, max_epochs=1, val_loader_fn=lambda e: batches[:1],
                       eval_hook=lambda st, epoch: hooked.append(epoch) or {"hooked": 1.0})
    assert state.step == 2 and hooked == [0] and last["hooked"] == 1.0
    assert np.isfinite(last["val_loss_total"]) and np.isfinite(last["loss_total"])
    assert (tmp_path / "ckpts" / "epoch_1.pt").is_file()
    assert all(g["lr"] == pytest.approx(LR / 2 * g["lr_mult"])
               for g in state.optimizer.param_groups)

    model2, state2 = _port_state(setup["variables"])
    trainer2 = Trainer(state2, str(tmp_path), **kw)
    assert trainer2.resume() == 1 and state2.step == 2
    for (name, p), p2 in zip(model.named_parameters(), model2.parameters()):
        np.testing.assert_array_equal(p2.detach().numpy(), p.detach().numpy(), err_msg=name)
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(state2.optimizer.state[p2][key].numpy(),
                                          state.optimizer.state[p][key].numpy())
    np.testing.assert_array_equal(state2.cum_samples.numpy(), state.cum_samples.numpy())
    assert torch.equal(state2.generator.get_state(), state.generator.get_state())
    # a fit that already reached max_epochs trains no further
    assert trainer2.fit(lambda epoch: batches, max_epochs=1) == {}
    assert state2.step == 2


def test_jax_leaves_cover_the_port():
    """Every parameter-shaped JAX tree maps onto every port parameter."""
    model = flagship(tiny=True, device="cpu")
    jm = _jax_model()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3))))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    arrays = port_arrays(model, {"params": zeros})
    assert set(arrays) == {n for n, _ in model.named_parameters()}
    assert len(list(_leaves(zeros))) > len(arrays)  # packed in_proj: 3 leaves, 1 tensor
