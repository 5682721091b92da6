"""Port parity: the two-stage training step against the JAX package's (f32,
CPU), over several AdamW steps, on the tiny MOTIFS and VCTree predcls
configs (ResNet-26 at base width 8, hidden 32, roi 64, 96 x 128, the
synthetic split's 7 classes and 5 predicates).

Both packages take the same seeded weights (JAX's init, noised), the
config's optimizer as both train CLIs build it (AdamW at the config's lr
0.03 scaled by batch 2 / 8, grad clip 35, the lr multipliers) and the same
loader batches (``to_twostage_batch`` with 256 train pairs, one sequential
stream). The two-stage heads have no dropout and draw nothing in the step,
so the steps are the same function. Checked: each of JAX's steps 1-4 (the
two train batches twice) taken by the port from JAX's state before it
gives JAX's losses within ``RTOL`` and its pre-clip gradient norm within
``RTOL`` or ten times its own sensitivity to rounding of the weights; both
packages' free runs diverge at the config's lr alike; and the port's
steps after the ``Trainer``'s checkpoint round trip (what ``--resume``
restores: weights, optimizer state, step, generator) give the
uninterrupted run's losses bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.config import apply_overrides as j_apply_overrides
from pairnet_tpu.config import load_config as j_load_config
from pairnet_tpu.data.pipeline import Loader as JLoader
from pairnet_tpu.data.pipeline import to_twostage_batch as j_to_twostage_batch
from pairnet_tpu.train import builder as j_builder
from pairnet_tpu.train.dispatch import get_loss_fn as j_get_loss_fn
from pairnet_tpu.train.optim import build_optimizer as j_build_optimizer
from pairnet_tpu.train.optim import step_lr_schedule as j_step_lr_schedule
from pairnet_tpu.train.trainer import TrainState as JTrainState
from pairnet_tpu.train.trainer import make_train_step as j_make_train_step
from test_torch_helpers import TINY_SPLIT, jax_dataset, perturb
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.config import apply_overrides, load_config  # noqa: E402
from pairnet_torch.train.builder import build_model, synthetic_root  # noqa: E402
from pairnet_torch.train.optim import build_optimizer, step_lr_schedule  # noqa: E402
from pairnet_torch.train.trainer import Trainer, TrainState, make_train_step  # noqa: E402
from pairnet_torch.utils.from_jax import load_jax_train_state, load_jax_variables  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"MotifHead": "motifs/panoptic_fpn_r50_predcls_psg.py",
           "VCTreeHead": "vctree/panoptic_fpn_r50_predcls_psg.py"}
TINY = ["data.pipeline.target_size=(96,128)", "data.pipeline.max_inst=8",
        "model.backbone.depth=26", "model.backbone.base_width=8",
        "model.relation_head.hidden_dim=32", "model.relation_head.roi_dim=64",
        "model.relation_head.context_pooling_dim=96", "model.relation_head.embed_dim=16",
        "model.relation_head.num_classes=8", "model.relation_head.num_predicates=6",
        "num_object_classes=7", "num_relation_classes=5", "evaluation.num_things=4"]
BATCH = 2
STEPS = 4
RTOL = 1e-4  # losses and gradient norm of each step, relative to JAX's
WEIGHT_NOISE = 1e-7  # relative, on every weight: the gradient norm's own f32 sensitivity


def options():
    return [f"data.dataset.data_root={synthetic_root(TINY_SPLIT)}", "data.dataset.synthetic=False",
            *TINY]


def base_lr(cfg):
    lr = cfg.optimizer.lr
    if cfg.optimizer.get("auto_scale_lr_base_batch"):
        lr = lr * BATCH / cfg.optimizer.auto_scale_lr_base_batch
    return lr


_runs = {}


def jax_run(head):
    """JAX's config, seeded variables, train batches and per-step metrics."""
    if head not in _runs:
        jcfg = j_apply_overrides(j_load_config(os.path.join(REPO, "configs", CONFIGS[head])),
                                 options())
        loader = JLoader(jax_dataset(synthetic_root(TINY_SPLIT), "train"),
                         j_builder.build_pipeline_cfg(jcfg, train=True), BATCH, train=True,
                         seed=jcfg.seed, num_workers=0,
                         sample_transform=lambda s, rng: j_to_twostage_batch(
                             s, jcfg.data.get("max_pairs", 256), train=True, rng=rng))
        batches = list(loader)
        jm = j_builder.build_detector(jcfg)
        init = {k: jnp.asarray(v[:1]) for k, v in batches[0].items()}
        variables = jax.tree_util.tree_map(np.asarray, perturb(
            jax.jit(jm.init)(jax.random.PRNGKey(0), init), seed=1, std=0.05))
        schedule = j_step_lr_schedule(base_lr(jcfg), len(batches), jcfg.schedule.decay_epochs,
                                      jcfg.schedule.gamma)
        tx = j_build_optimizer(variables["params"], weight_decay=jcfg.optimizer.weight_decay,
                               grad_clip=jcfg.optimizer.grad_clip,
                               custom_lr_keys=dict(jcfg.optimizer.custom_lr_keys),
                               schedule=schedule)
        state = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx,
                                   jcfg.num_relation_classes, seed=jcfg.seed)
        step = jax.jit(j_make_train_step(jm, tx, loss_fn=j_get_loss_fn(head, jcfg),
                                         apply_adapter=lambda m, v, b, **kw: m.apply(v, b, **kw)))
        states, metrics = [state], []
        for i in range(STEPS):
            state, m = step(state, {k: jnp.asarray(v) for k, v in
                                    batches[i % len(batches)].items()})
            states.append(state)
            metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
        _runs[head] = variables, batches, states, metrics
    return _runs[head]


def port_state(head, variables, n_batches):
    cfg = apply_overrides(load_config(os.path.join(REPO, "configs", CONFIGS[head])), options())
    model = load_jax_variables(build_model(cfg.model, device="cpu"), variables)
    opt = build_optimizer(model, base_lr(cfg), weight_decay=cfg.optimizer.weight_decay,
                          custom_lr_keys=dict(cfg.optimizer.custom_lr_keys))
    step = make_train_step(model, opt, dict(cfg.get("loss", {})),
                           schedule=step_lr_schedule(base_lr(cfg), n_batches,
                                                     cfg.schedule.decay_epochs,
                                                     cfg.schedule.gamma),
                           grad_clip=cfg.optimizer.grad_clip, head_type=head)
    return TrainState(model, opt, cfg.num_relation_classes, seed=cfg.seed), step


def run(step, state, batches, steps):
    return [{k: float(v) for k, v in step(state, {k: torch.as_tensor(v) for k, v in
                                                   batches[i % len(batches)].items()}).items()}
            for i in steps]


_free = {}


def port_free_run(head):
    """The port's own 4 steps from the seeded weights."""
    if head not in _free:
        variables, batches, _, _ = jax_run(head)
        state, step = port_state(head, variables, len(batches))
        _free[head] = run(step, state, batches, range(STEPS))
    return _free[head]


def port_step_from(head, variables, batches, jax_state, i, noise=0.0, seed=0):
    """The port's step ``i`` from JAX's state before it (``None``: the
    seeded weights), its weights first scaled by 1 + ``noise`` x N(0, 1)."""
    state, step = port_state(head, variables, len(batches))
    if jax_state is not None:
        load_jax_train_state(state, jax_state)
    if noise:
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in state.model.parameters():
                p.mul_(1 + noise * torch.randn(p.shape, generator=g))
    return run(step, state, batches, [i])[0]


@pytest.mark.parametrize("head", list(CONFIGS))
def test_adamw_steps_match_jax(head):
    """Each of JAX's 4 steps, taken by the port from JAX's state before it
    (``load_jax_train_state``: weights, Adam moments, step): JAX's losses
    within ``RTOL``, and its gradient norm within ``RTOL`` or ten times
    what noise of ``WEIGHT_NOISE`` on the weights alone moves the port's
    (the loss surface sharpens as the run diverges). Each step is held on
    its own because Adam's first updates, about lr x sign(g) for every
    weight, turn rounding into different trajectories within two steps."""
    variables, batches, states, want = jax_run(head)
    for i in range(STEPS):
        start = states[i] if i else None
        got = port_step_from(head, variables, batches, start, i)
        assert set(got) == set(want[i]), (sorted(got), sorted(want[i]))
        for k, w in want[i].items():
            if k != "grad_norm":
                np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=0,
                                           err_msg=f"step {i + 1} {k}")
        w = want[i]["grad_norm"]
        if abs(got["grad_norm"] - w) <= RTOL * w:
            continue
        spread = max(abs(port_step_from(head, variables, batches, start, i, WEIGHT_NOISE, s)[
            "grad_norm"] - got["grad_norm"]) for s in (1, 2)) / w
        assert 10 * spread < 1e-2, (i + 1, spread)
        np.testing.assert_allclose(got["grad_norm"], w, rtol=10 * spread, atol=0,
                                   err_msg=f"step {i + 1} grad_norm")


@pytest.mark.parametrize("head", list(CONFIGS))
def test_config_lr_diverges_in_both_packages(head):
    """At the config's lr (the reference's SGD lr, taken by AdamW in both
    packages) the relation loss grows over 100-fold within 4 steps from
    seeded weights, in JAX's run and in the port's run alike; the last
    loss is finite."""
    _, _, _, want = jax_run(head)
    for m in (want, port_free_run(head)):
        assert np.isfinite(m[-1]["loss_total"])
        assert max(s["loss_rel"] for s in m) > 100 * m[0]["loss_rel"], [s["loss_rel"] for s in m]


@pytest.mark.parametrize("head", list(CONFIGS))
def test_resumed_steps_equal_the_uninterrupted_run(head, tmp_path):
    """2 steps, the ``Trainer``'s checkpoint written and read back into a
    fresh state, 2 more steps: the uninterrupted run's losses exactly."""
    variables, batches, _, _ = jax_run(head)
    want = port_free_run(head)
    state, step = port_state(head, variables, len(batches))
    run(step, state, batches, range(2))
    Trainer(state, str(tmp_path)).save(1)
    resumed, step = port_state(head, variables, len(batches))
    assert Trainer(resumed, str(tmp_path)).resume() == 1
    assert run(step, resumed, batches, range(2, STEPS)) == want[2:]
