"""Shared helpers of the PyTorch port's parity tests (``tests/test_torch_*.py``).

Inputs and noise come from numpy seeds and reach both packages as numpy
arrays. Holds no tests itself.

Every port test file imports :func:`keep_torch_rng`, a module-scoped
autouse fixture: the file's tests run inside ``torch.random.fork_rng``, so
torch's global RNG is as the file found it when the next file of its
xdist worker starts. JAX test files that draw torch weights from the
global RNG (the mmdet mirrors of ``test_pixel_decoder_parity.py`` and
``test_pairnet_head_parity.py``) then draw the same ones whatever port
files ran before them.
"""

import numpy as np
import pytest


@pytest.fixture(scope="module", autouse=True)
def keep_torch_rng():
    """Run the importing module's tests with torch's global RNG forked:
    its state (CPU) is restored when the module's tests are done."""
    import torch

    with torch.random.fork_rng(devices=[]):
        yield

MSDA_SHAPES = ((20, 30), (10, 15), (5, 8))
TINY_SPLIT = {"num_images": 8, "num_test": 3, "seed": 1}  # tiny_synthetic's fixture


def jax_dataset(port_dataset_root, split):
    """The JAX package's PSGDataset on the port's synthetic fixture (the same
    files for both packages; the fixtures' equality is tested on its own).

    It first loads the JAX package's native preprocessing library in the
    calling thread. That library loads lazily and marks itself tried before
    it is loaded, so a loader thread that comes in between takes the PIL
    resize, whose rounding is a gray level off the native resize's, and that
    image parts from the port's."""
    from pairnet_tpu import native
    from pairnet_tpu.data.psg import PSGDataset

    assert native.available(), "the JAX package's native preprocessing library did not load"
    return PSGDataset("psg.json", data_root=port_dataset_root, split=split)


def msda_inputs(seed=0, wild=False, B=2, H=4, D=32, Q=700, P=4, shapes=MSDA_SHAPES):
    """value (B,S,H,D), locs (B,Q,H,L,P,2), weights (B,Q,H,L,P), all f32.

    ``wild`` spreads the locations over [-0.6, 1.6] so that many taps fall
    out of the plane; otherwise [-0.1, 1.1] (border corners only).
    """
    rng = np.random.default_rng(seed)
    lo, hi = (-0.6, 1.6) if wild else (-0.1, 1.1)
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.normal(size=(B, S, H, D)).astype(np.float32)
    locs = rng.uniform(lo, hi, size=(B, Q, H, L, P, 2)).astype(np.float32)
    w = rng.uniform(size=(B, Q, H, L, P)).astype(np.float32)
    return shapes, value, locs, w


def msda_hotspot_inputs(seed=0, B=2, H=4, D=32, Q=700, P=4, shapes=MSDA_SHAPES):
    """MSDA inputs whose taps all fall into one pixel cell of each level
    (the middle one), at positions jittered inside it: every query's
    corners land on the same four tokens per level and head, the most
    contended case of the backward's scatter into dvalue."""
    shapes, value, _, w = msda_inputs(seed, False, B, H, D, Q, P, shapes)
    rng = np.random.default_rng(seed + 100)
    L = len(shapes)
    locs = np.empty((B, Q, H, L, P, 2), np.float32)
    for lvl, (h, wd) in enumerate(shapes):
        for axis, n in ((0, wd), (1, h)):
            px = n // 2 + rng.uniform(0.05, 0.95, size=(B, Q, H, P))
            locs[:, :, :, lvl, :, axis] = (px + 0.5) / n
    return shapes, value, locs, w


QUANT_KINDS = ("bf16", "zero_channel", "ties")


def quantize_edge_values(kind, bound, seed=0, B=2, H=4, D=32, shapes=MSDA_SHAPES):
    """f32 values (B, S, H, D) for the quantize's edge semantics:

    * ``bf16``: N(0, 1) rounded to bf16 (to be handed over as bf16);
    * ``zero_channel``: N(0, 1) with channel (h 1, d 3) zero over level 1
      (half of it -0.0) and channel (h 0, d 0) zero over level 2 in image 0;
    * ``ties``: per (b, h, level, d) a power-of-two scale s, one token at
      +-bound * s (the absmax, so the scale is exactly s) and every other
      token at an exact half step (k + 0.5) * s, |k + 0.5| < bound, which
      rounds half to even. Every value has at most 8 significant bits.
    """
    import torch

    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in shapes)
    value = rng.normal(size=(B, S, H, D)).astype(np.float32)
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    if kind == "bf16":
        return torch.tensor(value).to(torch.bfloat16).float().numpy()
    if kind == "zero_channel":
        lvl1 = slice(starts[1], starts[2])
        value[:, lvl1, 1, 3] = 0.0
        value[:, starts[1]:starts[1] + (starts[2] - starts[1]) // 2, 1, 3] = -0.0
        value[0, starts[2]:starts[3], 0, 0] = 0.0
        return value
    assert kind == "ties", kind
    for lvl in range(len(shapes)):
        n = starts[lvl + 1] - starts[lvl]
        s = 2.0 ** rng.integers(-6, 4, size=(B, 1, H, D))
        k = rng.integers(-bound, bound, size=(B, n, H, D))
        v = (k + 0.5) * s
        at = rng.integers(0, n, size=(B, H, D))  # the absmax token of each channel
        sign = rng.choice([-1.0, 1.0], size=(B, H, D))
        bi, hi, di = np.indices((B, H, D))
        v[bi, at, hi, di] = sign * bound * s[:, 0]
        value[:, starts[lvl]:starts[lvl + 1]] = v
    return value


BORDER_SHAPES = ((16, 32), (8, 16), (4, 8))  # powers of two: the pixel positions are exact


def border_pixels(n):
    """Pixel coordinates (p * n - 0.5) on and beyond the border of an axis
    of n pixels: x0 = -1, x0 = n - 1, on integer pixels (0, n - 1, and -1,
    whose in-plane corner has weight 0), and wholly off the plane (x0 = -2,
    x0 = n)."""
    return np.array([-0.5, n - 0.75, 0.0, n - 1.0, -1.0, -1.5, n + 0.25], np.float32)


def msda_border_inputs(seed=0, B=2, H=4, D=32, Q=96, P=4, shapes=BORDER_SHAPES, all_off=False):
    """MSDA inputs whose tap coordinates are drawn per axis from
    :func:`border_pixels` and uniform pixels in [-1, n]; with ``all_off``
    every tap lies wholly off its plane. Returns (shapes, value, locs,
    weights, off): ``off`` (B, Q, H, L, P) marks the taps with no corner in
    the plane."""
    shapes, value, _, w = msda_inputs(seed, False, B, H, D, Q, P, shapes)
    rng = np.random.default_rng(seed + 200)
    L = len(shapes)
    locs = np.empty((B, Q, H, L, P, 2), np.float32)
    off = np.zeros((B, Q, H, L, P), bool)
    for lvl, (h, wd) in enumerate(shapes):
        for axis, n in ((0, wd), (1, h)):
            special = border_pixels(n)
            if all_off:
                special = special[special < -1.0] if axis else special[special >= n]
                px = rng.choice(special, size=(B, Q, H, P))
            else:
                px = np.where(rng.uniform(size=(B, Q, H, P)) < 0.7,
                              rng.choice(special, size=(B, Q, H, P)),
                              rng.uniform(-1.0, n, size=(B, Q, H, P)).astype(np.float32))
            locs[:, :, :, lvl, :, axis] = (px + 0.5) / n
            x0 = np.floor(locs[:, :, :, lvl, :, axis] * n - 0.5)
            off[:, :, :, lvl] |= (x0 < -1) | (x0 > n - 1)
    return shapes, value, locs, w, off


def to_numpy(tree):
    """A flax variable tree with numpy leaves (plain nested dicts)."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def perturb(tree, seed, std=0.1):
    """Seeded noise on every float leaf; ``running_var`` stays positive."""
    rng = np.random.default_rng(seed)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in sorted(node.items())}
        arr = np.asarray(node)
        noise = rng.normal(size=arr.shape).astype(arr.dtype)
        if name == "running_var":
            return arr + std * np.abs(noise)
        return arr + std * noise

    return walk(to_numpy(tree), "")


def nest(tree, *path):
    """``tree`` placed at ``path`` inside an otherwise empty tree."""
    for key in reversed(path):
        tree = {key: tree}
    return tree


def decided_ranks(values, k, tol):
    """For the top-``k`` of ``values`` (1-D, descending order), a bool per
    rank: True where the value is more than ``tol`` from both neighbours in
    the sorted order, so that no rounding of size ``tol`` can reorder it."""
    s = np.sort(np.asarray(values, np.float64))[::-1][: k + 1]
    gap = np.abs(np.diff(s))  # gap[i] = s[i] - s[i + 1]
    before = np.concatenate([[np.inf], gap[: k - 1]])
    after = gap[:k]
    return (before > tol) & (after > tol)


def attention_mask_logits(port, images):
    """The attention-mask logits the port's decoder consumed on ``images``
    (NHWC numpy), one (B, Q, S) array per mask: the initial query's and
    every layer output's but the last, taken at each layer's level. A bit
    is masked where its logit is below 0 (sigmoid < 0.5)."""
    import torch

    head = port.bbox_head
    dec = head.transformer_decoder
    seen = {}
    hooks = [
        head.pixel_decoder.register_forward_hook(lambda m, i, o: seen.update(pix=o)),
        dec.register_forward_hook(lambda m, i, o: seen.update(dec=o)),
    ]
    with torch.no_grad():
        port(torch.tensor(images))
        for h in hooks:
            h.remove()
        mask_features, ms_feats = seen["pix"]
        q0 = head.query_feat.weight[None].expand(images.shape[0], -1, -1)
        # the initial query and the output of every layer but the last
        queries = [q0] + list(seen["dec"]["query_history"][:-1])
        logits = []
        for i, q in enumerate(queries):
            hw = ms_feats[i % len(ms_feats)].shape[-2:]
            small = torch.nn.functional.interpolate(
                mask_features.float(), size=tuple(hw), mode="bilinear", align_corners=False
            ).flatten(2).transpose(1, 2)
            am = torch.einsum("bqc,bsc->bqs", dec._mask_embed(q, head.mask_embed), small)
            logits.append(am.numpy())
    return logits


def attention_mask_margin(port, images):
    """The least |logit| of :func:`attention_mask_logits`: every mask bit
    is decided by a margin of this size."""
    return min(float(np.abs(am).min()) for am in attention_mask_logits(port, images))


def zoo_batch(seed=0, B=2, H=64, W=96, G=6, Rm=8, num_classes=7, num_predicates=5):
    """A padded GT batch (numpy) for the one-stage zoo's losses: the image,
    labels, stride-4 f32 masks, validity, relations (1-based predicates),
    xyxy pixel boxes of the masks (an empty mask's box is zero) and the
    unpadded image shape. Every valid GT segment and every relation's
    endpoints are among the first 4 segments."""
    rng = np.random.default_rng(seed)
    masks = (rng.uniform(size=(B, G, H // 4, W // 4)) > 0.7).astype(np.float32)
    boxes = np.zeros((B, G, 4), np.float32)
    for b in range(B):
        for g in range(G):
            ys, xs = np.nonzero(masks[b, g])
            if len(ys):
                boxes[b, g] = [xs.min() * 4, ys.min() * 4, (xs.max() + 1) * 4, (ys.max() + 1) * 4]
    gt_valid = np.zeros((B, G), bool)
    gt_valid[:, :4] = True
    rel_valid = np.zeros((B, Rm), bool)
    rel_valid[:, :5] = True
    rels = np.stack([rng.integers(0, 4, size=(B, Rm)), rng.integers(0, 4, size=(B, Rm)),
                     rng.integers(1, num_predicates + 1, size=(B, Rm))], axis=-1)
    return {
        "image": rng.normal(size=(B, H, W, 3)).astype(np.float32),
        "gt_labels": rng.integers(0, num_classes, size=(B, G)).astype(np.int32),
        "gt_masks": masks,
        "gt_valid": gt_valid,
        "gt_rels": rels.astype(np.int32),
        "rel_valid": rel_valid,
        "gt_boxes": boxes,
        "image_shape": np.asarray([[H, W]] * B, np.int32),
    }


def zoo_pair(jax_head, port_head, kw, images, seed=2):
    """A tiny one-stage model (ResNet-26 at base width 8 and the head with
    ``kw``) in both packages on the same seeded-noise weights: (JAX model,
    its variables, its outputs on ``images`` as numpy, the port model, its
    outputs as numpy; per-layer lists kept)."""
    import jax
    import jax.numpy as jnp
    import torch

    from pairnet_torch.models.backbones.resnet import ResNet
    from pairnet_torch.models.frameworks.psgtr import PSGTr
    from pairnet_torch.utils.from_jax import load_jax_variables
    from pairnet_tpu.models.backbones.resnet import ResNet as JResNet
    from pairnet_tpu.models.frameworks.psgtr import PSGTr as JPSGTr

    jm = JPSGTr(backbone=JResNet(depth=26, base_width=8), bbox_head=jax_head(**kw))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    variables = perturb(numpy_init(shapes, seed), seed=seed, std=0.05)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(jm.apply)(variables, images))
    bb = ResNet(depth=26, base_width=8)
    port = load_jax_variables(PSGTr(bb, port_head(bb.out_channels, **kw)).eval(), variables)
    with torch.no_grad():
        out = tree_numpy(port(torch.tensor(images)))
    return jm, variables, ref, port, out


def numpy_init(shapes, seed):
    """Seeded numpy variables for the flax shape tree ``shapes``, by leaf
    name as flax's defaults: lecun-normal kernels, zero biases, unit norm
    scales, N(0, 1) tables; frozen BN at the identity; MSDA's sampling
    offsets and attention weights zero (their bias keeps the zero init:
    ``perturb`` moves everything after). Cheaper than running ``init``."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name == "kernel":
            return rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        if name in ("bias", "running_mean"):
            return np.zeros(shape)
        if name in ("scale", "running_var", "weight"):
            return np.ones(shape)
        return rng.normal(size=shape)

    def walk(node, path):
        if hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in sorted(node.items())}
        arr = leaf(path[-1], node.shape)
        if any(p in ("sampling_offsets", "attention_weights") for p in path):
            arr = np.zeros(node.shape)
        return arr.astype(np.float32)

    return walk(shapes, ())


def tree_numpy(tree):
    """Tensors of nested dicts / lists as numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_numpy(v) for v in tree]
    return tree.detach().numpy()


def tree_torch(tree, grad=False):
    """numpy leaves of nested dicts / lists as torch tensors (float leaves
    requiring grad when ``grad``)."""
    import torch

    if isinstance(tree, dict):
        return {k: tree_torch(v, grad) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_torch(v, grad) for v in tree]
    t = torch.tensor(np.asarray(tree))
    return t.requires_grad_() if grad and t.is_floating_point() else t


def tree_leaves(tree, prefix=""):
    """(dotted name, leaf) of nested dicts / lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def assert_close_rel(got, want, rtol, what=""):
    """max |got - want| <= rtol * max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = rtol * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= bound, (what, err, bound)
