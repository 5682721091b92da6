"""Port parity of the whole scoring path: ``python -m pairnet_torch.tools.test`` on
the tiny synthetic config against the JAX package's scoring path.

``tiny_synthetic`` at ``target_size=(256, 512)`` has a 32x64 = 2048-token
level, so the decoder takes the flash route; both packages run with
``PAIRNET_DEFORM_IMPL=pallas_v12`` (int8 MSDA) and ``PAIRNET_FLASH_ATTN=1``
in f32, on the same weights: the JAX model's, carried into a port
checkpoint. JAX runs its Pallas kernels in interpret mode.

The int8 codes are a discrete step: ~1e-6 differences of the two
packages' value projections move values across rounding ties. So the port
is fed the JAX run's value plane at each MSDA call (after checking that its
own is within 1e-4 of it; JAX runs landscape planes transposed, so they are
put back in row-major order first), and everything else is its own. The
split's 3 test images make one batch; the PQ run reuses the sgdet run's
JAX forward (the same batch), which keeps the interpret-mode kernels to
one run.

The int8 kernel's output is bf16 in both packages, rounded from f32 sums
taken in another order (and, for JAX, on the transposed plane), so a few
outputs that lie near a rounding boundary differ by one bf16 ulp (2^-8
relative). The mask logits, one linear step after the pixel decoder, carry
that straight through: they are held within ``MASK_ATOL`` (measured:
1.3e-3 on logits up to ~5), every other output within ``ATOL``. Discrete
outputs (labels, ranked pairs, mask bits) are held where their margin
exceeds 10x the measured gap of their inputs, and the metric dicts exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

import pairnet_tpu.ops.deform_attn as j_deform
import pairnet_tpu.ops.pallas_deform_attn_v12  # noqa: F401  (registers pallas_v12)
from pairnet_tpu.config import apply_overrides as j_apply_overrides
from pairnet_tpu.config import load_config as j_load_config
from pairnet_tpu.evaluation import runner as j_runner
from pairnet_tpu.models.heads.pairnet_inference import pairnet_postprocess as j_post
from pairnet_tpu.train import builder as j_builder
from test_torch_helpers import TINY_SPLIT, decided_ranks, jax_dataset, perturb
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.flagship import flagship  # noqa: E402
from pairnet_torch.models import layers  # noqa: E402
from pairnet_torch.tools import test as cli  # noqa: E402
from pairnet_torch.train.builder import synthetic_root  # noqa: E402
from pairnet_torch.utils.from_jax import load_jax_variables  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "pairnet", "tiny_synthetic.py")
OPTIONS = ["data.pipeline.target_size=(256,512)"]
ENV = {"PAIRNET_DEFORM_IMPL": "pallas_v12", "PAIRNET_FLASH_ATTN": "1"}
ATOL = 1e-4
MASK_ATOL = 2e-3  # mask, sub_seg, obj_seg: see the module doc
KEYS = ("cls", "mask", "rel", "importance", "sub", "obj", "sub_seg", "obj_seg")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's and the port's (metrics, per-forward outputs) for sgdet and PQ,
    and the largest gap between the two packages' own value planes."""
    cfg = j_apply_overrides(j_load_config(TINY), OPTIONS)
    dataset = jax_dataset(synthetic_root(TINY_SPLIT), "test")
    pipe_cfg = j_builder.build_pipeline_cfg(cfg, train=False)
    jm = j_builder.build_detector(cfg)
    # the parameters do not depend on the image size: initialise at a small one
    variables = perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))),
                        seed=2, std=0.05)
    work = tmp_path_factory.mktemp("work")
    (work / "ckpts").mkdir()
    port = load_jax_variables(flagship(tiny=True, device="cpu"), variables)
    torch.save({"epoch": 3, "state": {"model": port.state_dict()}}, work / "ckpts" / "epoch_3.pt")

    planes, outs = [], {"jax": [], "port": []}
    v12 = j_deform._PALLAS_IMPL["pallas_v12"]

    def recording_v12(value, shapes, locs, weights):
        jax.debug.callback(lambda v, s=tuple(shapes): planes.append((np.asarray(v), s)), value,
                           ordered=True)
        return v12(value, shapes, locs, weights)

    fwd = jax.jit(lambda v, img: jax.tree_util.tree_map(
        lambda t: t.astype(jnp.float32) if t.dtype == jnp.bfloat16 else t, jm.apply(v, img)))
    forwards = []

    def apply_j(img):
        if not forwards:
            forwards.append(fwd(variables, jnp.asarray(img, jnp.float32)))
        out = forwards[0]
        outs["jax"].append({k: np.asarray(out[k]) for k in (*KEYS, "sub_pos", "obj_pos")})
        return out

    kw = dict(batch_size=3, num_things=cfg.evaluation.num_things)
    gaps = []
    orig_msda, orig_apply_fn = layers.ms_deform_attn, cli.make_apply_fn

    def fed_msda(value, shapes, locs, weights, impl=None, bwd="exact"):
        jv, jshapes = planes[len(gaps) % len(planes)]
        if jshapes != tuple(shapes):  # transposed planes: back to row-major
            assert jshapes == tuple((w, h) for h, w in shapes), (jshapes, shapes)
            B, _, H, D = jv.shape
            starts = np.cumsum([0] + [h * w for h, w in shapes])
            jv = np.concatenate([
                jv[:, a:b].reshape(B, w, h, H, D).transpose(0, 2, 1, 3, 4).reshape(B, b - a, H, D)
                for (h, w), a, b in zip(shapes, starts[:-1], starts[1:])], axis=1)
        jv = torch.tensor(jv)
        gaps.append(float((value - jv).abs().max()))
        return orig_msda(jv, shapes, locs, weights, impl=impl, bwd=bwd)

    def recording_apply_fn(*args):
        fn = orig_apply_fn(*args)

        def apply_fn(images):
            out = fn(images)
            outs["port"].append({k: out[k].numpy() for k in (*KEYS, "sub_pos", "obj_pos")})
            return out
        return apply_fn

    argv = [TINY, str(work), "--batch-size", "3", "--dtype", "f32", "--device", "cpu",
            "--cfg-options", *OPTIONS]
    res = {}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        mp.setitem(j_deform._PALLAS_IMPL, "pallas_v12", recording_v12)
        with pltpu.force_tpu_interpret_mode():
            res["jax sgdet"] = j_runner.evaluate_model_device(
                apply_j, dataset, pipe_cfg, mode="sgdet",
                num_predicates=cfg.num_relation_classes, iou_thr=0.5, **kw)
            res["jax PQ"] = j_runner.evaluate_pq(apply_j, j_post, dataset, pipe_cfg,
                                                 num_classes=cfg.num_object_classes, **kw)
        jax.effects_barrier()
        mp.setattr(layers, "ms_deform_attn", fed_msda)
        mp.setattr(cli, "make_apply_fn", recording_apply_fn)
        res["port sgdet"] = cli.main([*argv[:2], "--eval", "sgdet", *argv[2:]])
        res["port PQ"] = cli.main([*argv[:2], "--eval", "PQ", *argv[2:]])
    assert len(planes) == 1 and len(gaps) == 2
    return res, outs, max(gaps)


def test_port_value_planes_are_close(runs):
    """The substitution only moves the port's own values by f32 noise."""
    _, outs, gap = runs
    assert len(outs["port"]) == len(outs["jax"]) == 2  # one batch for sgdet, one for PQ
    assert gap < 1e-4, gap


@pytest.mark.parametrize("key", KEYS)
def test_outputs_match_jax(runs, key):
    _, outs, _ = runs
    for t, j in zip(outs["port"], outs["jax"]):
        assert t[key].shape == j[key].shape
        atol = MASK_ATOL if key in ("mask", "sub_seg", "obj_seg") else ATOL
        np.testing.assert_allclose(t[key], j[key], atol=atol, rtol=0)


def test_triplets_match_jax_under_margins(runs):
    """Per image: the sub/obj labels where the top class leads the next by
    10x the gap, the ranked pairs at decided ranks, the sub/obj mask bits
    where the logit is 10x the gap from 0 (each gap that of the output the
    decision reads)."""
    _, outs, _ = runs
    n_ranks = n_bits = 0
    for t, j in zip(outs["port"], outs["jax"]):
        gap = {k: np.abs(t[k] - j[k]).max() for k in KEYS}
        for key in ("sub", "obj"):
            top2 = np.sort(j[key][..., :-1], axis=-1)[..., -2:]
            ok = top2[..., 1] - top2[..., 0] > 10 * gap[key]
            np.testing.assert_array_equal(t[key][..., :-1].argmax(-1)[ok],
                                          j[key][..., :-1].argmax(-1)[ok])
        for b in range(j["importance"].shape[0]):
            K = j["sub_pos"].shape[1]
            ok = decided_ranks(j["importance"][b].ravel(), K, 10 * gap["importance"])
            n_ranks += ok.sum()
            np.testing.assert_array_equal(t["sub_pos"][b][ok], j["sub_pos"][b][ok])
            np.testing.assert_array_equal(t["obj_pos"][b][ok], j["obj_pos"][b][ok])
        for key in ("sub_seg", "obj_seg"):
            ok = np.abs(j[key]) > 10 * gap[key]
            n_bits += ok.sum()
            np.testing.assert_array_equal((t[key] > 0)[ok], (j[key] > 0)[ok])
    assert n_ranks > 0 and n_bits > 0.9 * sum(j[k].size for j in outs["jax"]
                                              for k in ("sub_seg", "obj_seg"))


@pytest.mark.parametrize("what", ["sgdet", "PQ"])
def test_metrics_equal_jax(runs, what):
    """The metric dicts, value for value; the port's key set is JAX's
    tools/test.py's: the engine's keys plus the eval time and images/s."""
    res, _, _ = runs
    port, ref = dict(res[f"port {what}"]), res[f"jax {what}"]
    timing = {f"{what}_eval_time_s", f"{what}_images_per_s"}
    assert set(port) == set(ref) | timing
    for k in timing:
        del port[k]
    assert port == ref


@pytest.mark.parametrize("config, tiny", [("tiny_synthetic.py", True), ("pairnet_r50_psg.py", False)])
def test_build_model_equals_flagship(config, tiny):
    """The config's model is ``flagship()`` at ``_flagship``'s widths: the
    same modules, names and seeded weights."""
    from pairnet_torch.config import load_config
    from pairnet_torch.models.frameworks.psgtr import build_model

    cfg = load_config(os.path.join(REPO, "configs", "pairnet", config))
    got = build_model(cfg.model, device="cpu").state_dict()
    want = flagship(tiny=tiny, device="cpu").state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("change, error, match", [
    ({"type": "SceneGraphTwoStage"}, NotImplementedError, "model type.*ROADMAP"),
    ({"backbone": {"type": "RegNet"}}, NotImplementedError, "backbone.*ROADMAP"),
    ({"bbox_head": {"type": "MotifHead"}}, NotImplementedError, r"head.*ROADMAP.*A\.2-A\.3"),
    # every matrix learner of the JAX package is ported: only an unknown one raises
    ({"bbox_head": {"mapper": "conv_huge"}}, KeyError, "unknown matrix learner"),
], ids=["change0-model type", "change1-backbone", "change2-head", "change3-mapper"])
def test_build_model_raises_for_what_is_not_ported(change, error, match):
    from pairnet_torch.config import load_config
    from pairnet_torch.models.frameworks.psgtr import build_model

    model = load_config(TINY).model.merge(change)
    with pytest.raises(error, match=match):
        build_model(model, device="cpu")


@pytest.mark.parametrize("env, dtype, impl", [
    (None, "bf16", "int4"), (None, "f32", "exact"), ("pallas_v16", "f32", "int4"),
    ("pallas_v12", "bf16", "int8"), ("pallas_v14", "f32", "int8"), ("pallas_v6", "bf16", "exact"),
    ("pallas_v7", "bf16", "exact"), ("rows", "bf16", "plain"), ("patch", "f32", "plain"),
    ("pallas_v10", "bf16", None),
])
def test_cli_reads_the_jax_kernel_names(monkeypatch, env, dtype, impl):
    """``PAIRNET_DEFORM_IMPL`` as a JAX user sets it; the dispatcher's
    refused anchors (v10, v11) and unknown names raise."""
    if env is None:
        monkeypatch.delenv("PAIRNET_DEFORM_IMPL", raising=False)
    else:
        monkeypatch.setenv("PAIRNET_DEFORM_IMPL", env)
    if impl is None:
        with pytest.raises(ValueError, match="PAIRNET_DEFORM_IMPL"):
            cli.deform_impl(dtype)
    else:
        assert cli.deform_impl(dtype) == impl


def test_cli_loads_the_newest_checkpoint(tmp_path):
    """``ckpts/epoch_<n>.pt`` by epoch number (10 after 9), and none raises."""
    model = torch.nn.Linear(2, 2)
    (tmp_path / "ckpts").mkdir()
    for epoch in (9, 10):
        sd = {k: torch.full_like(v, epoch) for k, v in model.state_dict().items()}
        torch.save({"epoch": epoch, "state": {"model": sd}},
                   tmp_path / "ckpts" / f"epoch_{epoch}.pt")
    cli.load_weights(model, str(tmp_path))
    assert torch.equal(model.weight, torch.full((2, 2), 10.0))
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        cli.load_weights(model, str(tmp_path / "empty"))
