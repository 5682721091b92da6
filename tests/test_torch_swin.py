"""Port parity: the Swin Transformer backbone of ``pairnet_torch`` against
``pairnet_tpu.models.backbones.swin.SwinTransformer`` (CPU).

A tiny Swin (embed 16, depths (1, 1, 2, 1), heads (1, 2, 4, 8), window 4)
with seeded noise on every weight, at 64x64 (no stage pads) and 72x88
(every block pads to a window multiple and the merges see odd extents).
The weights reach the port through ``load_jax_variables`` and go back to
JAX through the JAX package's ``convert_swin``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.models.backbones.swin import SwinTransformer as JSwin
from pairnet_tpu.utils.torch_convert import convert_swin, unflatten
from test_torch_helpers import nest, perturb
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.models.backbones.swin import SwinTransformer  # noqa: E402
from pairnet_torch.utils.from_jax import (  # noqa: E402
    _leaves,
    load_jax_variables,
    port_arrays,
    tensor_leaves,
)

TINY = dict(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8), window=4)
SIZES = [(64, 64), (72, 88)]
RTOL_F32 = 1e-5  # x max(1, max |ref|)
RTOL_BF16 = 2e-2  # x max |ref|, per block
RTOL_GRAD = 1e-4  # x max |grad| of each parameter


def _port(variables):
    with torch.device("meta"):
        model = SwinTransformer(**TINY)
    model = model.to_empty(device="cpu")
    return load_jax_variables(model, {"params": nest(variables["params"], "backbone")},
                              prefix="backbone.")


@pytest.fixture(scope="module", params=SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def tiny(request):
    """(JAX module, noised variables, port model, NHWC images)."""
    hw = request.param
    jm = JSwin(**TINY)
    variables = perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3))), seed=1)
    images = np.random.default_rng(0).normal(size=(2, *hw, 3)).astype(np.float32)
    return jm, variables, _port(variables), images


def _run_port(model, images):
    return [o.permute(0, 2, 3, 1) for o in model(torch.tensor(images).permute(0, 3, 1, 2))]


def test_f32_outputs_match_jax(tiny):
    jm, variables, model, images = tiny
    ref = [np.asarray(r) for r in jax.jit(jm.apply)(variables, images)]
    with torch.no_grad():
        got = [o.numpy() for o in _run_port(model, images)]
    assert len(got) == len(ref) == 4
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=RTOL_F32 * max(1.0, np.abs(r).max()), rtol=0)


def _block_inputs(model, images):
    """The NHWC input of every block and merge of the port's f32 forward:
    [(("stage<s>_block<b>" | "merge<s>"), module, input)]."""
    seen, hooks = [], []
    for s, stage in enumerate(model.stages):
        for b, blk in enumerate(stage.blocks):
            hooks.append(blk.register_forward_pre_hook(
                lambda m, a, name=f"stage{s}_block{b}": seen.append((name, m, a[0]))))
        if stage.downsample is not None:
            hooks.append(stage.downsample.register_forward_pre_hook(
                lambda m, a, name=f"merge{s}": seen.append((name, m, a[0]))))
    with torch.no_grad():
        _run_port(model, images)
    for h in hooks:
        h.remove()
    return seen


def test_bf16_blocks_match_jax(tiny):
    """Every block and merge in bf16 (weights and input) against the JAX
    module on the same bf16 input: the scores written in bf16 with the bias
    and the shift mask added in bf16, the tanh GELU, the padding. Module by
    module, because the two packages round at other points (JAX rounds a
    Dense's product before adding the bias, torch once), and over the whole
    tiny backbone those last-bit differences accumulate in the bf16 residual
    stream to ~2e-2 of the outputs, as far as JAX's own bf16 run lies from
    its f32 run."""
    from pairnet_tpu.models.backbones.swin import PatchMerging as JMerge
    from pairnet_tpu.models.backbones.swin import SwinBlock as JBlock

    _, variables, model, images = tiny
    params = variables["params"]
    w = TINY["window"]
    checked = 0
    for name, module, x in _block_inputs(model, images):
        x16 = x.to(torch.bfloat16)
        if name.startswith("merge"):
            jmod = JMerge(module.reduction.out_features)
        else:
            s = int(name[5])
            jmod = JBlock(x.shape[-1], TINY["num_heads"][s], w, shift=module.attn.shift)
        p16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params[name])
        ref = jax.jit(jmod.apply)({"params": p16}, jnp.asarray(x16.float().numpy(), jnp.bfloat16))
        with torch.no_grad():
            got = copy.deepcopy(module).to(torch.bfloat16)(x16)
        assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        r = np.asarray(ref, np.float32)
        err = np.abs(got.float().numpy() - r).max()
        assert err <= RTOL_BF16 * np.abs(r).max(), (name, err, np.abs(r).max())
        checked += 1
    assert checked == sum(TINY["depths"]) + len(TINY["depths"]) - 1


def test_gradients_match_jax(tiny):
    """The gradient of a fixed linear functional of the four outputs with
    respect to every parameter."""
    jm, variables, model, images = tiny
    rng = np.random.default_rng(5)
    shapes = [r.shape for r in jax.eval_shape(jm.apply, variables, images)]
    coefs = [rng.normal(size=s).astype(np.float32) for s in shapes]

    def functional(params):
        outs = jm.apply({"params": params}, images)
        return sum(jnp.sum(o * c) for o, c in zip(outs, coefs))

    jgrads = jax.jit(jax.grad(functional))(variables["params"])
    want = port_arrays(model, {"params": nest(jax.tree_util.tree_map(np.asarray, jgrads),
                                              "backbone")}, prefix="backbone.")
    model.zero_grad()
    outs = _run_port(model, images)
    sum((o * torch.tensor(c)).sum() for o, c in zip(outs, coefs)).backward()
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, atol=RTOL_GRAD * np.abs(g).max(), rtol=0,
                                   err_msg=name)


def test_state_dict_through_convert_swin_gives_jax_outputs(tiny):
    """The port's ``state_dict()`` through the JAX package's converter
    drives the JAX module to the port's outputs."""
    jm, _, model, images = tiny
    params = unflatten(convert_swin(model.state_dict()))
    ref = jax.jit(jm.apply)({"params": params}, images)
    with torch.no_grad():
        got = _run_port(model, images)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, atol=RTOL_F32 * max(1.0, np.abs(r).max()),
                                   rtol=0)


def test_weight_round_trip_is_bit_exact(tiny):
    """JAX leaves -> port -> state_dict -> ``convert_swin`` gives back every
    leaf bit for bit (the PatchMerging permutation included), and reads
    every key of the state dict."""
    _, variables, model, _ = tiny

    class Tracked(dict):
        read = set()

        def __getitem__(self, k):
            self.read.add(k)
            return dict.__getitem__(self, k)

    sd = Tracked(model.state_dict())
    back = unflatten(convert_swin(sd))
    assert set(sd) == sd.read, sorted(set(sd) - sd.read)
    want, got = dict(_leaves(variables["params"])), dict(_leaves(back))
    assert set(want) == set(got), sorted(set(want) ^ set(got))
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg="/".join(k))


def test_swin_b_keys_and_shapes_close_both_ways():
    """At Swin-B's defaults, built on meta: every port tensor's flax leaves
    exist with the shape it needs, every flax leaf is taken by a port
    tensor, and ``convert_swin`` of the port's keys gives the flax tree."""
    jm = JSwin()
    want = {tuple(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 96, 96, 3))))["params"])}
    with torch.device("meta"):
        model = SwinTransformer()
    state = model.state_dict()
    zeros = {k: np.broadcast_to(np.float32(0), s) for k, s in want.items()}
    used = set()
    for name, col, paths, fn in tensor_leaves(model, "backbone."):
        keys = [p[1:] for p in paths]  # drop the "backbone" scope
        assert col == "params" and all(k in want for k in keys), (name, paths)
        used.update(keys)
        assert fn([zeros[k] for k in keys]).shape == tuple(state[name].shape), name
    assert used == set(want), sorted(set(want) - used)
    sd = {k: np.broadcast_to(np.float32(0), tuple(v.shape)) for k, v in state.items()}
    got = {tuple(k.split("/")): np.shape(v) for k, v in convert_swin(sd).items()}
    assert got == want


def test_cached_tensors_serve_a_later_training_forward(tiny):
    """The relative-position index and the shift masks are cached; made
    during an inference-mode forward, they still serve a training forward
    and its backward."""
    from pairnet_torch.models.backbones import swin

    _, _, model, images = tiny
    swin.rel_pos_index.cache_clear()
    swin.shift_mask.cache_clear()
    with torch.inference_mode():
        _run_port(model, images)
    model.zero_grad()
    sum(o.sum() for o in _run_port(model, images)).backward()
    assert all(p.grad is not None for p in model.parameters())
