"""Port parity: the batched on-device Hungarian of ``pairnet_torch`` against
scipy's ``linear_sum_assignment`` and the JAX package's ``batched_hungarian``.

Square, tall and wide problems, with padded rows and columns, are solved
together in one batch (problems whose search ends early keep their state
while the others go on). Continuous costs have one optimum, which scipy
finds; integer costs have ties, where the port must take the JAX solver's
choice (the same algorithm and the same first-minimum tie order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from pairnet_tpu.ops.hungarian import batched_hungarian as j_batched_hungarian

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.ops.hungarian import PAD_COST, batched_hungarian  # noqa: E402

SHAPES = [(7, 7), (11, 5), (5, 11), (20, 24), (100, 24)]


def _problems(n, m, seed, integer, B=4):
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, 4, size=(B, n, m)).astype(np.float32) if integer \
        else rng.normal(size=(B, n, m)).astype(np.float32)
    row_mask = np.ones((B, n), bool)
    col_mask = np.ones((B, m), bool)
    # problem 1 pads rows, 2 pads columns, 3 both; pads carry wild costs
    row_mask[1, n - n // 3:] = False
    col_mask[2, m - m // 3:] = False
    row_mask[3, :1] = False
    col_mask[3, m // 2: m // 2 + 2] = False
    cost[~row_mask] = 1e9
    cost.transpose(0, 2, 1)[~col_mask] = -1e9
    return cost, row_mask, col_mask


def _solve(cost, row_mask, col_mask):
    r2c, c2r = batched_hungarian(torch.tensor(cost), torch.tensor(row_mask),
                                 torch.tensor(col_mask))
    return r2c.numpy(), c2r.numpy()


@pytest.mark.parametrize("n,m", SHAPES)
def test_matches_scipy(n, m):
    cost, row_mask, col_mask = _problems(n, m, seed=n * 100 + m, integer=False)
    r2c, c2r = _solve(cost, row_mask, col_mask)
    for b in range(cost.shape[0]):
        rows, cols = np.flatnonzero(row_mask[b]), np.flatnonzero(col_mask[b])
        sub = cost[b][np.ix_(rows, cols)]
        ri, ci = linear_sum_assignment(sub)
        want_r2c = np.full(n, -1)
        want_r2c[rows[ri]] = cols[ci]
        want_c2r = np.full(m, -1)
        want_c2r[cols[ci]] = rows[ri]
        np.testing.assert_array_equal(r2c[b], want_r2c, err_msg=f"problem {b}")
        np.testing.assert_array_equal(c2r[b], want_c2r, err_msg=f"problem {b}")


@pytest.mark.parametrize("n,m", SHAPES)
@pytest.mark.parametrize("integer", [False, True], ids=["unique", "ties"])
def test_matches_jax(n, m, integer):
    cost, row_mask, col_mask = _problems(n, m, seed=n + 7 * m, integer=integer)
    r2c, c2r = _solve(cost, row_mask, col_mask)
    j_r2c, j_c2r = j_batched_hungarian(jnp.asarray(cost), jnp.asarray(row_mask),
                                       jnp.asarray(col_mask))
    np.testing.assert_array_equal(r2c, np.asarray(j_r2c))
    np.testing.assert_array_equal(c2r, np.asarray(j_c2r))


def test_no_masks_and_host_sync_count():
    """Without masks every row of a square problem is matched; the solver
    counts one host sync per search iteration."""
    cost = np.random.default_rng(1).normal(size=(2, 6, 6)).astype(np.float32)
    before = batched_hungarian.syncs
    r2c, c2r = batched_hungarian(torch.tensor(cost))
    assert sorted(r2c[0].tolist()) == list(range(6)) and (c2r >= 0).all()
    assert batched_hungarian.syncs - before >= 6
    assert PAD_COST == 1e6
