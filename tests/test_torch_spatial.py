"""The port's sequence-parallel deformable encoder
(``pairnet_torch/parallel/spatial.py``) on gloo ranks against the JAX
package's sequential stack, with the bound of
``tests/test_spatial_parallel.py``: S = 126 tokens split over 4 ranks (not
a multiple of 4, so the padding path runs) and over a 2 x 2 (data, model)
mesh; outputs within atol 2e-5 / rtol 1e-5, gradients through the
all-gather's backward within 5e-5 / 1e-4."""

import jax
import numpy as np
import pytest

from pairnet_tpu.models.layers import encoder_reference_points
from pairnet_tpu.models.necks.pixel_decoder import DeformableEncoderLayer as JEncLayer
from test_torch_dist import run_ranks, sp_encoder
from test_torch_helpers import perturb
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.models.necks.pixel_decoder import DeformableEncoderLayer  # noqa: E402
from pairnet_torch.parallel.spatial import sequence_parallel_encoder  # noqa: E402
from pairnet_torch.utils.from_jax import load_jax_variables, port_arrays  # noqa: E402

SHAPES = ((8, 12), (4, 6), (2, 3))
LAYER = dict(embed_dims=32, num_heads=4, num_levels=3, num_points=2, feedforward_channels=64)
PREFIX = "bbox_head.pixel_decoder.encoder.layers.0."


def _layer():
    """A layer built on meta and made on the CPU (its values are loaded
    next): nothing is drawn from torch's global generator, which other
    tests of the worker seed at import."""
    with torch.device("meta"):
        layer = DeformableEncoderLayer(**LAYER)
    return layer.to_empty(device="cpu")


def _rooted(params):
    return {"params": {"bbox_head": {"pixel_decoder": {"encoder_layer_0": params}}}}


@pytest.fixture(scope="module")
def reference():
    """Inputs, the JAX sequential stack's output (2 layers) and its
    gradients through the first layer, and the port's state dicts."""
    S = sum(h * w for h, w in SHAPES)
    assert S == 126
    B, C = 2, LAYER["embed_dims"]
    rng = np.random.default_rng(0)
    tokens = rng.normal(size=(B, S, C)).astype(np.float32)
    pos = (rng.normal(size=(B, S, C)) * 0.1).astype(np.float32)
    ref = np.broadcast_to(np.asarray(encoder_reference_points(SHAPES))[None], (B, S, 3, 2))
    ref = np.ascontiguousarray(ref, np.float32)
    jl = JEncLayer(*LAYER.values())
    params = [perturb(jl.init(jax.random.PRNGKey(i), tokens, pos, ref, SHAPES), i)["params"]
              for i in range(2)]
    expect = tokens
    for p in params:
        expect = jl.apply({"params": p}, expect, pos, ref, SHAPES)

    def loss(p):
        out = jl.apply({"params": p}, tokens, pos, ref, SHAPES)
        return (out * out).mean()

    grads = jax.grad(loss)(params[0])
    port = _layer()
    sds = [{k: v.numpy().copy() for k, v in load_jax_variables(port, _rooted(p), PREFIX)
            .state_dict().items()} for p in params]
    want_grads = port_arrays(port, _rooted(jax.device_get(grads)), PREFIX)
    return {"tokens": tokens, "pos": pos, "ref": ref, "expect": np.asarray(expect),
            "grads": want_grads, "state_dicts": sds}


MESHES = [(1, 4), (2, 2)]


@pytest.fixture(scope="module")
def sp_runs(reference, tmp_path_factory):
    """Each rank's results on each mesh of ``MESHES``, from one spawn of 4
    gloo ranks."""
    r = reference
    return run_ranks(sp_encoder, 4, tmp_path_factory.mktemp("sp"), LAYER, r["state_dicts"],
                     r["tokens"], r["pos"], r["ref"], SHAPES, MESHES)


@pytest.mark.parametrize("case", range(len(MESHES)), ids=["sp4", "dp2_sp2"])
def test_sequence_parallel_encoder_matches_jax(reference, sp_runs, case):
    r = reference
    n_data, n_model = MESHES[case]
    for rank, got in enumerate(runs[case] for runs in sp_runs):
        lo, hi = got["rows"]
        assert hi - lo == 2 // n_data
        np.testing.assert_allclose(got["out"], r["expect"][lo:hi], atol=2e-5, rtol=1e-5,
                                   err_msg=f"rank {rank}")
        assert set(got["grads"]) == set(r["grads"])
        for name, want in r["grads"].items():
            np.testing.assert_allclose(got["grads"][name], want, atol=5e-5, rtol=1e-4,
                                       err_msg=f"rank {rank} {name}")
        # the gathered plane holds each rank's 3 rows in rank order
        assert got["plane"] == [float(m) for m in range(n_model) for _ in range(3)]


def test_sequence_parallel_encoder_checks_its_layers():
    """A layer built without the group's ``seq_group`` is refused before
    any collective."""
    layer = _layer()

    class Group:  # stands for a process group; never reached
        pass

    x = torch.zeros(1, 126, LAYER["embed_dims"])
    with pytest.raises(ValueError, match="seq_group=group"):
        sequence_parallel_encoder([layer], x, x, torch.zeros(1, 126, 3, 2), SHAPES, Group())
