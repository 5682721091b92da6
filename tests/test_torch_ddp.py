"""The port's data-parallel train step and train CLI on 2 gloo ranks.

The tiny flagship (f32, the Relation Fusion FFN's dropout off) takes one
step on a global batch of 4 whose two halves hold unequal numbers of valid
segments (5, 5 | 2, 3) and relations (6, 5 | 1, 2), so a per-rank mean
differs from the global one. Held in three places:
(a) the port's world-1 step on the whole batch, (b) JAX's ``make_train_step``
on ``shard_batch(make_mesh(n_data=2))`` over the conftest's CPU mesh, from
the same weights and the JAX step's points, with ``tests/test_torch_train.py``'s
tolerances save where JAX's sharded program departs from its unsharded one
(see the test), and (c) every rank, bit-equal. Then the NaN guard on both ranks
and the train CLI at world 2 against the CLI at world 1 on the same global
batch. One spawn of 2 ranks runs all three, beside the JAX compile.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from __graft_entry__ import _flagship
from pairnet_tpu.parallel import mesh as j_mesh
from pairnet_tpu.train.optim import build_optimizer as j_build_optimizer
from pairnet_tpu.train.trainer import TrainState as JTrainState
from pairnet_tpu.train.trainer import make_train_step as j_make_train_step
from test_torch_dist import Ranks, calls, ddp_nan_guard, ddp_step, ddp_train_cli
from test_torch_helpers import perturb
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.flagship import flagship  # noqa: E402
from pairnet_torch.models.heads.pairnet_loss import pairnet_loss  # noqa: E402
from pairnet_torch.tools import train as train_cli  # noqa: E402
from pairnet_torch.train import trainer as trainer_mod  # noqa: E402
from pairnet_torch.train.optim import DEFAULT_LR_KEYS, build_optimizer, lr_mult_tree  # noqa: E402
from pairnet_torch.train.trainer import TrainState, make_train_step  # noqa: E402
from pairnet_torch.utils.from_jax import load_jax_variables, port_arrays  # noqa: E402

B, H, W = 4, 64, 96  # the global batch; 2 rows a rank
G, R = 6, 8
VALID_SEGMENTS = (5, 5, 2, 3)
VALID_RELATIONS = (6, 5, 1, 2)
NUM_POINTS = 64
LOSS = {"num_points": NUM_POINTS, "with_seg_losses": True}  # every normalizer of the loss
NUM_REL = 5
LR = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "pairnet", "tiny_synthetic.py")
# 8 train images: 2 steps an epoch at a global batch of 4; no dropout
CLI_OPTIONS = ["data.dataset.synthetic={'num_images':11,'num_test':3,'seed':1}",
               "model.bbox_head.relation_ffn_drop=0.0"]


def _jax_model():
    jm = _flagship(tiny=True)
    return jm.clone(bbox_head=jm.bbox_head.clone(relation_ffn_drop=0.0))


def _batch(port, images, seed=0):
    """GT masks from the port's own predictions of distinct queries, so the
    mask assignment is decided by a wide margin; each image's number of
    valid segments and relations from ``VALID_SEGMENTS`` / ``VALID_RELATIONS``."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        out = port.eval()(torch.tensor(images))
    Q, C = out["cls"].shape[1], out["cls"].shape[2] - 1
    q = np.stack([rng.permutation(Q)[:G] for _ in range(B)])
    masks = out["mask"].numpy()[np.arange(B)[:, None], q] > 0
    labels = np.stack([rng.permutation(C)[:G] for _ in range(B)]).astype(np.int32)
    rels = np.zeros((B, R, 3), np.int32)
    for b, (n_seg, n_rel) in enumerate(zip(VALID_SEGMENTS, VALID_RELATIONS)):
        pairs = rng.permutation(n_seg * n_seg)[:R]
        rels[b, : len(pairs)] = np.stack([pairs // n_seg, pairs % n_seg,
                                          rng.integers(1, NUM_REL + 1, len(pairs))], -1)
    return {"image": images, "gt_labels": labels, "gt_masks": masks,
            "gt_valid": np.arange(G)[None] < np.asarray(VALID_SEGMENTS)[:, None],
            "gt_rels": rels, "rel_valid": np.arange(R)[None] < np.asarray(VALID_RELATIONS)[:, None]}


@pytest.fixture(scope="module")
def inputs():
    """The perturbed JAX variables, the port's state dict of them, the
    batch and the JAX step's points for the global batch."""
    images = np.random.default_rng(0).normal(size=(B, H, W, 3)).astype(np.float32)
    jm = _jax_model()
    variables = perturb(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3))), seed=2,
                        std=0.05)
    # sharper class predictions, so the triplet assignment is decided
    variables["params"]["bbox_head"]["transformer_decoder"]["cls_embed"]["kernel"] *= 4
    port = load_jax_variables(flagship(tiny=True, device="cpu", relation_ffn_drop=0.0),
                              variables)
    tx = j_build_optimizer(variables["params"], base_lr=LR)
    state0 = JTrainState.create(variables, tx, NUM_REL)
    _, points_rng, _ = jax.random.split(state0.rng, 3)
    return {"variables": variables, "tx": tx, "state0": state0, "batch": _batch(port, images),
            "points": np.asarray(jax.random.uniform(points_rng, (B, NUM_POINTS, 2))),
            "state_dict": {k: v.numpy().copy() for k, v in port.state_dict().items()}}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """The 2 ranks, started: the step, the NaN guard (on half the batch,
    rank 1's loss NaN) and the train CLI; joined by ``rank_results``."""
    tmp = tmp_path_factory.mktemp("ddp")
    half = {k: v[:2] for k, v in inputs["batch"].items()}
    named = [("step", ddp_step, (inputs["state_dict"], inputs["batch"], inputs["points"], LR,
                                 NUM_REL, LOSS)),
             ("nan_guard", ddp_nan_guard, (inputs["state_dict"], half, NUM_REL, LOSS,
                                           str(tmp / "nan"))),
             ("cli", ddp_train_cli, (TINY, str(tmp / "cli"), CLI_OPTIONS))]
    return Ranks(calls, 2, tmp, named, timeout=240, env={"PAIRNET_DEBUG_NANS": "1"})


@pytest.fixture(scope="module")
def jax_step(inputs, ranks):
    """JAX's sharded step from the same state (compiled while the ranks run)."""
    jm = _jax_model()
    state0 = inputs["state0"]
    mesh = j_mesh.make_mesh(n_data=2)
    step = jax.jit(j_make_train_step(jm, inputs["tx"], LOSS))
    jbatch = j_mesh.shard_batch(mesh, {k: jnp.asarray(v) for k, v in inputs["batch"].items()})
    assert len(jbatch["image"].addressable_shards) == 2
    state1, metrics = step(j_mesh.replicate(mesh, state0), jbatch)
    return jax.device_get(state1), jax.device_get(metrics)


@pytest.fixture(scope="module")
def world1_step(inputs, ranks):
    """The port's world-1 step on the whole batch."""
    model = flagship(tiny=True, device="cpu", relation_ffn_drop=0.0)
    model.load_state_dict({k: torch.tensor(v) for k, v in inputs["state_dict"].items()})
    opt = build_optimizer(model, base_lr=LR)
    state = TrainState(model, opt, NUM_REL)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(trainer_mod, "sample_points", lambda *a: torch.tensor(inputs["points"]))
        step = make_train_step(model, opt, LOSS)
        metrics = step(state, {k: torch.tensor(v) for k, v in inputs["batch"].items()})
    finally:
        mp.undo()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.numpy() for n, p in model.named_parameters()},
            "params": {n: p.detach().numpy() for n, p in model.named_parameters()},
            "cum_samples": state.cum_samples.numpy(), "model": model}


@pytest.fixture(scope="module")
def rank_results(ranks, jax_step, world1_step):
    return ranks.join()


def _close_steps(got, ref, rtol, grad_tol, grad_l2, exceptions=None):
    """Metrics within ``rtol``; each gradient within ``grad_tol`` x its
    max |ref| (+1e-9), and all of them within ``grad_l2`` in L2; the
    parameters within Adam's first-step limit from the gradient difference
    (lr x min(2, 1e-3 + 2 d / (|g| + 1e-8)), plus two f32 ulps).
    ``exceptions[name] = (entries, cap)``: in that leaf, only the entries
    ``entries`` (an index into it) may exceed ``grad_tol``, and by at most
    ``cap`` x its max |ref|."""
    assert set(got["metrics"]) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=rtol, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got["cum_samples"], ref["cum_samples"])
    diff2 = ref2 = 0.0
    for name, g_ref in ref["grads"].items():
        g = got["grads"][name]
        tol = np.full(g_ref.shape, grad_tol * np.abs(g_ref).max() + 1e-9)
        if exceptions is not None and name in exceptions:
            entries, cap = exceptions[name]
            tol[entries] = cap * np.abs(g_ref).max()
        np.testing.assert_array_less(np.abs(g - g_ref), tol, err_msg=name)
        diff2 += float(np.sum((g.astype(np.float64) - g_ref) ** 2))
        ref2 += float(np.sum(g_ref.astype(np.float64) ** 2))
    assert ref2 > 0 and diff2 ** 0.5 <= grad_l2 * ref2 ** 0.5, (diff2 ** 0.5, ref2 ** 0.5)
    mults = lr_mult_tree(flagship(tiny=True, device="cpu"), DEFAULT_LR_KEYS)
    for name, p_ref in ref["params"].items():
        g_ref = ref["grads"][name]
        d = np.abs(got["grads"][name] - g_ref)
        tol = LR * mults[name] * np.minimum(2.0, 1e-3 + 2 * d / (np.abs(g_ref) + 1e-8)) \
            + 2 * np.spacing(np.abs(p_ref))
        np.testing.assert_array_less(np.abs(got["params"][name] - p_ref), tol, err_msg=name)


def test_batch_discriminates_global_from_per_rank_normalizers(inputs, world1_step):
    """The two halves' normalizers differ: averaging each half's own loss
    (a per-rank mean that DDP then averages) moves the losses far from the
    global batch's, so the identities below catch it."""
    model, batch = world1_step["model"], inputs["batch"]
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    tb["gt_masks"] = tb["gt_masks"].float()
    points = torch.tensor(inputs["points"])
    with torch.no_grad():
        out = model.eval()(tb["image"])
        whole, _ = pairnet_loss(out, tb, points, torch.zeros(NUM_REL), with_seg_losses=True)
        halves = [pairnet_loss({k: v[r * 2:(r + 1) * 2] for k, v in out.items()},
                               {k: v[r * 2:(r + 1) * 2] for k, v in tb.items()},
                               points[r * 2:(r + 1) * 2], torch.zeros(NUM_REL),
                               with_seg_losses=True)[0]
                  for r in range(2)]
    for k in ("loss_r_cls", "loss_sub_cls", "loss_match", "loss_mask", "loss_dice"):
        per_rank = (float(halves[0][k]) + float(halves[1][k])) / 2
        assert abs(per_rank - float(whole[k])) > 1e-3 * abs(float(whole[k])), k


def test_ranks_are_bit_equal(rank_results):
    """(c): every rank ends the step with the same losses, grad_norm,
    gradients, parameters and Seesaw counts, bit for bit."""
    a, b = (r["step"] for r in rank_results)
    assert a["metrics"] == b["metrics"]
    np.testing.assert_array_equal(a["cum_samples"], b["cum_samples"])
    for name in a["params"]:
        np.testing.assert_array_equal(a["grads"][name], b["grads"][name], err_msg=name)
        np.testing.assert_array_equal(a["params"][name], b["params"][name], err_msg=name)


def test_ddp_step_equals_world1_step(rank_results, world1_step):
    """(a): the step of 2 ranks is the world-1 step of the global batch:
    losses, grad_norm and gradients (leaf by leaf, of each leaf's max, and
    in L2) within 1e-5 relative, Seesaw counts equal, parameters within
    Adam's limit from the gradient difference."""
    _close_steps(rank_results[0]["step"], world1_step, rtol=1e-5, grad_tol=1e-5, grad_l2=1e-5)
    assert float(world1_step["cum_samples"].sum()) > 0


def test_ddp_step_equals_jax_sharded_step(inputs, rank_results, jax_step):
    """(b): JAX's step sharded over a 2-device data mesh: losses and
    grad_norm within 1e-4 (``tests/test_torch_train.py``'s tolerance),
    Seesaw counts equal; the gradients, read from JAX's first Adam moment,
    leaf by leaf within test_torch_train's 2e-3 of the leaf's max, with
    three named exceptions, and within 1e-3 in L2. On this batch JAX's
    sharded program departs from its own unsharded one (which agrees with
    the port's world-1 step within test_torch_train's tolerances): every
    leaf moves by ~7e-4 of its norm, so 7.7e-4 in L2 where
    test_torch_train holds 1e-4; unit 15 of ``bbox_head.obj_query_update.0``
    (a weight row and its bias) by up to 1.9e-2 of the leaf's max, held
    within 3e-2; and two entries of ``backbone.layer4.2.conv2`` by 2.2e-3,
    held within 4e-3. The bounds are fixed numbers, not the port's own
    world-1 distance from JAX."""
    state1, metrics = jax_step
    model = flagship(tiny=True, device="cpu")
    adam = state1.opt_state[1][0]
    mu = port_arrays(model, {"params": adam.mu})
    ref = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {k: v / 0.1 for k, v in mu.items()},
           "params": port_arrays(model, {"params": state1.params["params"]}),
           "cum_samples": np.asarray(state1.cum_samples)}
    unit = 15
    exceptions = {"bbox_head.obj_query_update.0.weight": (unit, 3e-2),
                  "bbox_head.obj_query_update.0.bias": (unit, 3e-2),
                  "backbone.layer4.2.conv2.weight": (([45, 63], [21, 21], [1, 1], [2, 2]),
                                                     4e-3)}
    _close_steps(rank_results[0]["step"], ref, rtol=1e-4, grad_tol=2e-3, grad_l2=1e-3,
                 exceptions=exceptions)


def test_nan_guard_raises_on_every_rank(rank_results):
    """Only rank 1's loss is NaN; the guard's decision is summed over the
    ranks, so both raise at the first step and neither waits on the other."""
    for r in rank_results:
        assert r["nan_guard"] is not None and "NaN losses at epoch 0 iter 0" in r["nan_guard"]


def test_train_cli_at_world_2(rank_results, tmp_path):
    """The train CLI on 2 ranks (``--device cpu``): 2 steps of a global
    batch of 4, the lr scaled by it, one checkpoint, then ``--resume``
    continues at epoch 1; the losses equal the world-1 CLI's on the same
    global batch (``data.samples_per_device=4``)."""
    ref = train_cli.main([TINY, "--device", "cpu", "--work-dir", str(tmp_path), "--max-steps",
                          "2", "--cfg-options", *CLI_OPTIONS, "data.samples_per_device=4"])
    assert (ref["steps_per_epoch"], ref["steps"]) == (2, 2)
    for rank, r in enumerate(rank_results):
        first, second = r["cli"]["first"], r["cli"]["second"]
        assert (first["rank"], first["world"]) == (rank, 2)
        assert (first["start_epoch"], first["steps_per_epoch"], first["steps"]) == (0, 2, 2)
        assert (second["start_epoch"], second["steps"]) == (1, 2)
        assert r["cli"]["ckpts"] == ["epoch_1.pt", "epoch_2.pt"]
        for k, v in ref["last"].items():
            np.testing.assert_allclose(first["last"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
        # lr 1e-3 x global batch 4 / auto_scale_lr_base_batch 8, as at world 1
        assert r["cli"]["epoch_1"]["step"] == 2
        for lr, mult in r["cli"]["epoch_1"]["lrs"]:
            assert lr == pytest.approx(5e-4 * mult)
