"""Port parity: the whole tiny Pair-Net flagship of ``pairnet_torch``
against ``_flagship(tiny=True)`` of the JAX package (f32, CPU).

Landscape 2x64x96 images send the JAX pixel decoder down its transposed-
plane route; the row-major port must agree. Every parameter carries seeded
noise. Discrete steps (the top-k pair pick, the sigmoid < 0.5 attention
masks, the fusion argmax) are compared under margin guards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from __graft_entry__ import _flagship
from pairnet_tpu.models.heads.pairnet_inference import panoptic_fusion as j_fusion
from pairnet_tpu.models.heads.pairnet_inference import pairnet_postprocess as j_post
from pairnet_tpu.utils.torch_convert import convert_pairnet_checkpoint
from test_torch_helpers import attention_mask_margin, decided_ranks, perturb
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.flagship import flagship  # noqa: E402
from pairnet_torch.models.heads.pairnet_inference import panoptic_fusion  # noqa: E402
from pairnet_torch.models.heads.pairnet_inference import pairnet_postprocess  # noqa: E402
from pairnet_torch.utils.from_jax import _leaves, load_jax_variables  # noqa: E402

NUM_THINGS = 4  # of the tiny model's 7 classes, so stuff dedup runs too
ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(JAX outputs, port outputs, JAX variables, port model, images)."""
    images = np.random.default_rng(0).normal(size=(2, 64, 96, 3)).astype(np.float32)
    jm = _flagship(tiny=True)
    variables = perturb(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3))), seed=2,
                        std=0.05)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(jm.apply)(variables, images))
    port = load_jax_variables(flagship(tiny=True, device="cpu"), variables)
    with torch.no_grad():
        out = {k: v.numpy() for k, v in port(torch.tensor(images)).items()}
    return ref, out, variables, port, images


def test_weight_round_trip_is_bit_exact(pair):
    """JAX leaves -> port -> state_dict -> the JAX package's checkpoint
    converter gives back every leaf bit for bit, and reads every key."""
    _, _, variables, port, _ = pair

    class Tracked(dict):
        read = set()

        def __getitem__(self, k):
            self.read.add(k)
            return dict.__getitem__(self, k)

    sd = Tracked(port.state_dict())
    back = convert_pairnet_checkpoint(sd)
    assert set(sd) == sd.read, sorted(set(sd) - sd.read)
    for col in ("params", "constants"):
        want = dict(_leaves(variables[col]))
        got = dict(_leaves(back[col]))
        assert set(want) == set(got), sorted(set(want) ^ set(got))
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg="/".join(k))


@pytest.mark.parametrize("key", ["cls", "mask", "importance", "queries", "rel"])
def test_forward_matches_jax(pair, key):
    ref, out, _, _, _ = pair
    assert out[key].shape == ref[key].shape
    np.testing.assert_allclose(out[key], ref[key], atol=ATOL, rtol=0)


def test_attention_masks_have_margin(pair):
    """The sigmoid < 0.5 attention masks are decided far from their
    boundary: every mask logit the decoder consumed is further from 0 than
    10x the largest gap between the two packages' final mask logits (the
    same contraction at full resolution), so no mask bit can differ."""
    ref, out, _, port, images = pair
    gap = np.abs(out["mask"] - ref["mask"]).max()
    margin = attention_mask_margin(port, images)
    assert margin > 10 * gap, (margin, gap)


def test_pair_indices_match_under_margin(pair):
    """sub_pos / obj_pos agree at every top-k rank whose importance is more
    than the tolerance away from its neighbours in the sorted order."""
    ref, out, _, _, _ = pair
    B, Q, _ = ref["importance"].shape
    K = ref["sub_pos"].shape[1]
    n_decided = 0
    for b in range(B):
        ok = decided_ranks(ref["importance"][b].ravel(), K, ATOL)
        n_decided += ok.sum()
        np.testing.assert_array_equal(out["sub_pos"][b][ok], ref["sub_pos"][b][ok])
        np.testing.assert_array_equal(out["obj_pos"][b][ok], ref["obj_pos"][b][ok])
    assert n_decided >= B * K // 2, n_decided


@pytest.mark.parametrize("b", [0, 1])
def test_postprocess_matches_jax(pair, b):
    ref, out, _, _, _ = pair
    j = j_post({k: jnp.asarray(v) for k, v in ref.items()}, b, num_things=NUM_THINGS)
    t = pairnet_postprocess({k: torch.tensor(v) for k, v in out.items()}, b,
                            num_things=NUM_THINGS)
    np.testing.assert_array_equal(t.pan_seg.numpy(), np.asarray(j.pan_seg))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    np.testing.assert_allclose(t.r_scores.numpy(), np.asarray(j.r_scores), atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_panoptic_fusion_matches_jax(seed):
    """Random confident logits: kept queries, stuff dedup and the
    iterative small-segment prune all run; the same inputs go to both."""
    rng = np.random.default_rng(seed)
    Q, C, H, W = 12, 6, 24, 32
    cls = (rng.normal(size=(Q, C + 1)) * 4).astype(np.float32)
    mask = (rng.normal(size=(Q, H, W)) * 3).astype(np.float32)
    mask[: Q // 2] += np.linspace(0, 6, Q // 2, dtype=np.float32)[:, None, None]
    j = j_fusion(jnp.asarray(cls), jnp.asarray(mask), num_things=3)
    t = panoptic_fusion(torch.tensor(cls), torch.tensor(mask), num_things=3)
    np.testing.assert_array_equal(t.pan_seg.numpy(), np.asarray(j.pan_seg))
    np.testing.assert_array_equal(t.keep.numpy(), np.asarray(j.keep))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
