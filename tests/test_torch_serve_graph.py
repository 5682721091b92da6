"""The serving forward as CUDA graph replays (``utils/serve_graph.py``).

On the CPU: ``serve`` runs eagerly and counts so; the segments cut into a
model leave its eager forward, hooks and gradients as they were; what a
capture keeps alive; which models are capturable; the counters in
``tracing.snapshot()``; the MSDA's cached level sizes against the formula
they replace, bit for bit.

Marked ``cuda``, against the eager forward on the GPU (they need an NVIDIA
GPU and nvcc, and skip without them): Pair-Net R-50 and Swin-B, tiny (f32,
the exact MSDA) and at full width (bf16, int4 MSDA), at batch 1 and 2:
``bench.serve`` from graphs equals the eager ``model(images)`` and
``pairnet_postprocess`` bit for bit, at the capture and at replays; hooks
at the kept module boundaries see each request's tensors; returned outputs
survive the next request; keys, the MSDA switch, moved parameters and the
least-recently-used bound; cached device tensors the graphs read are kept
alive. On a GPU machine::

    python -m pytest --noconftest tests/test_torch_serve_graph.py -m cuda
"""

import os

import pytest

from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")

from pairnet_torch.bench import serve  # noqa: E402
from pairnet_torch.flagship import flagship, perturb_deform_kernels, set_deform_impl  # noqa: E402
from pairnet_torch.models.heads.pairnet_inference import pairnet_postprocess  # noqa: E402
from pairnet_torch.ops.deform_attn_int4 import int4_gather, int4_quantize  # noqa: E402
from pairnet_torch.utils import serve_graph, tracing  # noqa: E402

CASES = {  # (backbone, tiny) -> (dtype, MSDA, image (H, W), things)
    ("r50", True): (torch.float32, "exact", (64, 96), 4),
    ("swinb", True): (torch.float32, "exact", (64, 96), 4),
    ("r50", False): (torch.bfloat16, "int4", (256, 384), 80),
    ("swinb", False): (torch.bfloat16, "int4", (256, 384), 80),
}
IDS = [f"{bb}-{'tiny' if tiny else 'full'}" for bb, tiny in CASES]
TINY_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs", "pairnet", "tiny_synthetic.py")


def build(bb, tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dtype, impl = CASES[bb, tiny][:2]
    model = perturb_deform_kernels(flagship(tiny, device="cuda", dtype=dtype, backbone=bb))
    return set_deform_impl(model, impl)


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(bb, tiny):
        if (bb, tiny) not in built:
            built[bb, tiny] = build(bb, tiny)
        return built[bb, tiny]

    return get


def images(case, batch, seed, hw=None):
    dtype, _, size, _ = CASES[case]
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((batch, *(hw or size), 3), generator=g, device="cuda").to(dtype)


def eager(model, x, things):
    with torch.inference_mode():
        out = model(x)
        return out, [pairnet_postprocess(out, b, things) for b in range(x.shape[0])]


def counts():
    return {k: v for k, v in tracing.snapshot().items() if k.startswith("serve_graph.")}


def assert_same(got, want):
    (out, preds), (ref, ref_preds) = got, want
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype and torch.equal(out[k], ref[k]), k
    assert len(preds) == len(ref_preds)
    for p, r in zip(preds, ref_preds):
        for f in r._fields:
            assert torch.equal(getattr(p, f), getattr(r, f)), f


class Taps:
    """The benchmark's hooks: each decoder layer's attention mask (its 5th
    argument), the pixel decoder's mask features, each kept module's
    forward hook calls."""

    def __init__(self, model):
        self.masks, self.mask_features, self.calls, self.handles = [], [], [], []
        for name, module in model.named_modules():
            if name.startswith("bbox_head.transformer_decoder.layers.") and name.count(".") == 3:
                self.handles.append(module.register_forward_pre_hook(
                    lambda mod, args: self.masks.append(args[4][:, 0].clone())))
        self.handles.append(model.bbox_head.pixel_decoder.register_forward_hook(
            lambda mod, args, out: self.mask_features.append(out[0].clone())))
        for name in ("backbone", "bbox_head", "bbox_head.pixel_decoder",
                     "bbox_head.transformer_decoder"):
            self.handles.append(model.get_submodule(name).register_forward_hook(
                lambda *_, name=name: self.calls.append(name)))

    def close(self):
        for h in self.handles:
            h.remove()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("case", list(CASES), ids=IDS)
def test_graphs_equal_eager(models, case, batch):
    """Capture, then two replays of other images: each equal to the eager
    forward and post-processing bit for bit, one capture and two replays
    counted. The MSDA wrappers count where they run: twice a layer at the
    capture (warm-up and capture), not at a replay."""
    model, things = models(*case), CASES[case][3]
    x = [images(case, batch, seed) for seed in (1, 2, 3)]
    want = [eager(model, xi, things) for xi in x]
    layers = len(model.bbox_head.pixel_decoder.encoder.layers)
    int4 = CASES[case][1] == "int4"
    before = counts()
    launches = (int4_quantize.launches, int4_gather.launches)
    assert_same(serve(model, x[0], things), want[0])
    assert (int4_quantize.launches - launches[0],
            int4_gather.launches - launches[1]) == ((2 * layers,) * 2 if int4 else (0, 0))
    for i in (1, 2):
        launches = (int4_quantize.launches, int4_gather.launches)
        assert_same(serve(model, x[i], things), want[i])
        assert (int4_quantize.launches, int4_gather.launches) == launches
    assert tracing.difference(before, counts()) == {
        "serve_graph.captures": 1, "serve_graph.replays": 2, "serve_graph.eager": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES), ids=IDS)
def test_hooks_see_each_request(models, case):
    """The benchmark's hooks at the kept boundaries: one mask a decoder
    layer and the mask features, equal to the eager forward's, at the
    capture and at a replay; each kept module's forward hook once."""
    model, things = models(*case), CASES[case][3]
    x = [images(case, 2, seed, hw=(96, 128)) for seed in (4, 5)]
    layers = len(model.bbox_head.transformer_decoder.layers)
    for xi in x:  # the first captures this shape, the second replays
        taps = Taps(model)
        try:
            eager(model, xi, things)
            want = (taps.masks, taps.mask_features, taps.calls)
            taps.masks, taps.mask_features, taps.calls = [], [], []
            serve(model, xi, things)
        finally:
            taps.close()
        assert len(taps.masks) == len(want[0]) == layers
        assert all(torch.equal(a, b) for a, b in zip(taps.masks, want[0]))
        assert len(taps.mask_features) == 1 and torch.equal(taps.mask_features[0], want[1][0])
        assert taps.calls == want[2] and len(taps.calls) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["conv_small", "conv_base", "attn", "fc", "direct"])
def test_other_heads_equal_eager(variant):
    """The tiny config's Pair-Net with each other matrix learner, and the
    direct head, built by ``build_model``: graphed equal to eager."""
    from pairnet_torch.config import apply_overrides, load_config
    from pairnet_torch.models.frameworks.psgtr import build_model

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    opt = ("model.bbox_head.direct=True" if variant == "direct"
           else f"model.bbox_head.mapper={variant}")
    cfg = apply_overrides(load_config(TINY_CONFIG), [opt])
    model = set_deform_impl(perturb_deform_kernels(build_model(cfg.model, device="cuda")),
                            "exact")
    for seed in (13, 14):  # capture, replay
        x = images(("r50", True), 2, seed)
        assert_same(serve(model, x, 4), eager(model, x, 4))


@pytest.mark.cuda
def test_results_outlive_the_next_request(models):
    case = ("r50", False)
    model = models(*case)
    a, b = images(case, 1, 6), images(case, 1, 7)
    out_a, preds_a = serve(model, a)
    kept = ({k: v.clone() for k, v in out_a.items()}, [type(p)(*(t.clone() for t in p))
                                                        for p in preds_a])
    serve(model, a)  # a replay
    got_b = serve(model, b)
    assert_same((out_a, preds_a), kept)
    assert_same(got_b, eager(model, b, 80))


@pytest.mark.cuda
def test_keys_switches_and_moves(monkeypatch):
    """A new shape captures once and then replays; the least recently used
    key goes beyond ``KEYS``; another MSDA implementation, or a parameter
    moved, captures anew; each result equal to the eager one."""
    case = ("r50", True)
    model, things = build(*case), CASES[case][3]  # no graphs yet
    monkeypatch.setattr(serve_graph, "KEYS", 2)
    x = {hw: images(case, 1, 8, hw) for hw in ((64, 96), (96, 64), (96, 96))}

    def run(hw, expect):
        before = counts()
        assert_same(serve(model, x[hw], things), eager(model, x[hw], things))
        got = tracing.difference(before, counts())
        assert got == {"serve_graph.captures": expect == "capture",
                       "serve_graph.replays": expect == "replay", "serve_graph.eager": 0}

    a, b, c = x
    steps = [(a, "capture"), (a, "replay"), (b, "capture"), (a, "replay"),
             (c, "capture"),  # drops b, the least recently used
             (a, "replay"), (b, "capture"), ("plain", None), (b, "capture"), (b, "replay"),
             ("exact", None), (b, "replay"),  # the exact graphs of b are still kept
             ("moved", None), (b, "capture"), (b, "replay")]
    for hw, expect in steps:
        if hw in ("plain", "exact"):
            set_deform_impl(model, hw)
        elif hw == "moved":  # the graphs read the old storage
            p = model.bbox_head.cls_embed.weight
            p.data = p.data.clone()
        else:
            run(hw, expect)


@pytest.mark.cuda
@pytest.mark.parametrize("bb", ["r50", "swinb"])
def test_cached_tensors_outlive_their_caches(models, bb):
    """The MSDA level sizes and Swin's masks come from caches; the graphs
    keep what they read alive, whatever the caches drop: a replay after the
    caches are cleared and freed memory written over is still exact."""
    from pairnet_torch.models.backbones import swin
    from pairnet_torch.models.layers import level_sizes

    case = (bb, True)
    model, things = models(*case), CASES[case][3]
    x = images(case, 1, 9, (80, 112))
    want = eager(model, x, things)
    serve(model, x, things)  # capture
    segments = next(reversed(serve_graph._models[model].keys.values()))
    reads = [t for seg in segments for t in seg.reads]
    assert any(t.shape == (3, 2) and t.dtype == torch.float32 for t in reads)  # level sizes
    assert bb == "r50" or any(  # Swin's shift masks
        t.dim() == 3 and t.shape[1] == t.shape[2] and bool(((t == 0) | (t == -100)).all())
        and bool((t == -100).any()) for t in reads)
    level_sizes.cache_clear()
    swin.shift_mask.cache_clear()
    swin.rel_pos_index.cache_clear()
    junk = [torch.full((n,), float("nan"), device="cuda")
            for n in (2 ** k for k in range(1, 20)) for _ in range(8)]
    assert_same(serve(model, x, things), want)
    del junk


@pytest.mark.cuda
def test_eager_where_not_capturable(models):
    """A model in train mode runs eagerly and counts so; a model of other
    parts is not capturable."""
    model = models("r50", True)
    x = images(("r50", True), 1, 10)
    before = counts()
    model.train()
    try:
        serve(model, x, 4)
    finally:
        model.eval()
    assert tracing.difference(before, counts())["serve_graph.eager"] == 1
    assert not serve_graph.capturable(torch.nn.Sequential(model.backbone))


# --- on the CPU


def test_cpu_serve_is_eager_and_counted():
    model = flagship(tiny=True, device="cpu")
    x = torch.randn((2, 64, 96, 3), generator=torch.Generator().manual_seed(11))
    want = eager(model, x, 4)
    before = counts()
    assert_same(serve(model, x, 4), want)
    assert tracing.difference(before, counts()) == {
        "serve_graph.captures": 0, "serve_graph.replays": 0, "serve_graph.eager": 1}
    assert model not in serve_graph._models  # nothing kept for a CPU forward


def test_snapshot_holds_the_counts():
    snap = tracing.snapshot()
    assert set(tracing.COUNTS) == {"serve_graph.captures", "serve_graph.replays",
                                   "serve_graph.eager"} and set(tracing.COUNTS) <= set(snap)
    tracing.count("serve_graph.eager")
    assert tracing.difference(snap, tracing.snapshot())["serve_graph.eager"] == 1


def test_cut_keeps_the_eager_forward():
    """The segments cut into a model's instances call their functions
    outside a graphed forward: the same outputs, hooks and gradients; a
    second cut changes nothing."""
    model = flagship(tiny=True, device="cpu")
    x = torch.randn((1, 64, 96, 3), generator=torch.Generator().manual_seed(15))
    taps = Taps(model)
    try:
        want, _ = eager(model, x, 4)
        serve_graph._cut(model)
        cut = {n: vars(m)["forward"] for n, m in model.named_modules() if "forward" in vars(m)}
        serve_graph._cut(model)
        got, _ = eager(model, x, 4)
    finally:
        taps.close()
    layers = model.bbox_head.transformer_decoder.layers
    assert set(cut) == {"backbone", "bbox_head.pixel_decoder",
                        *(f"bbox_head.transformer_decoder.layers.{i}" for i in range(len(layers)))}
    assert all(vars(m)["forward"] is cut[n] for n, m in model.named_modules() if n in cut)
    assert {k for k in ("positions", "pair") if k in vars(model.bbox_head)} == {"positions", "pair"}
    assert_same((got, []), (want, []))
    assert len(taps.masks) == 2 * len(layers) and len(taps.mask_features) == 2
    assert taps.calls == 2 * ["backbone", "bbox_head.pixel_decoder",
                              "bbox_head.transformer_decoder", "bbox_head"]
    model.train()
    model(x)["cls"].float().sum().backward()
    assert model.backbone.conv1.weight.grad is not None


def test_reads_keeps_what_no_operation_made():
    """Of the tensors that operations read, those that no operation in the
    mode made, once a storage."""
    a, b = torch.ones(3), torch.arange(3.0)
    reads = serve_graph._Reads()
    with reads:
        c = a + b
        d = (c * a)[1:]
        d.add_(b[:2])
    assert c.data_ptr() not in reads.read and len(reads.read) == 2
    assert {id(t) for t in reads.read.values()} == {id(a), id(b)}


def test_capturable_by_types():
    from pairnet_torch.models.frameworks.psgtr import PSGTr
    from pairnet_torch.models.heads.baseline_head import BaselineHead

    for bb in ("r50", "swinb"):
        assert serve_graph.capturable(flagship(tiny=True, device="cpu", backbone=bb))
    model = flagship(tiny=True, device="cpu")
    with torch.device("meta"):
        other = PSGTr(model.backbone, BaselineHead(model.backbone.out_channels, num_classes=7,
                                                   num_relations=5, embed_dims=32,
                                                   num_heads=4))
    assert not serve_graph.capturable(other)
    assert not serve_graph.capturable(torch.nn.Sequential(model.backbone))
    model.bbox_head.pixel_decoder.encoder.layers[0].attentions[0].seq_group = object()
    assert not serve_graph.capturable(model)  # an MSDA split over ranks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_level_sizes_equal_the_previous_normalizer(dtype, monkeypatch):
    """The MSDA's sampling locations with the cached level sizes equal, bit
    for bit, those of the tensor it built on every call, at 3 levels; a
    training forward after a served one can still take the gradient."""
    import pairnet_torch.models.layers as layers

    shapes = ((5, 7), (10, 14), (20, 28))
    g = torch.Generator().manual_seed(12)
    m = layers.MSDeformAttention(32, 4, 3, 4)
    for p in m.parameters():
        p.data = torch.randn(p.shape, generator=g) * 0.5
    m = m.to(dtype)
    S = sum(h * w for h, w in shapes)
    x = torch.randn((2, S, 32), generator=g).to(dtype)
    ref = layers.encoder_reference_points(shapes)[None].expand(2, -1, -1, -1)
    seen = []
    orig = layers.ms_deform_attn

    def record(value, spatial_shapes, locs, weights, **kw):
        seen.append(locs)
        return orig(value, spatial_shapes, locs, weights, **kw)

    monkeypatch.setattr(layers, "ms_deform_attn", record)
    with torch.inference_mode():
        m(x, x, ref, list(shapes))
    offsets = layers.linear_promoted(x, m.sampling_offsets).reshape(2, S, 4, 3, 4, 2)
    previous = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32)
    want = ref[:, :, None, :, None, :].float() + (
        offsets.float() / previous[None, None, None, :, None, :])
    assert torch.equal(seen[0], want)
    m(x.float().to(dtype).requires_grad_(), x, ref, shapes).float().sum().backward()
