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
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.ops.hungarian import (  # noqa: E402
    MAX_COLS,
    PAD_COST,
    SHORT_COLS,
    batched_hungarian,
    batched_hungarian_plain,
)

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


def _jax_pair(cost, row_mask=None, col_mask=None):
    """The port's and the JAX solver's (row2col, col2row) on ``cost``."""
    masks = [None if m is None else torch.tensor(m) for m in (row_mask, col_mask)]
    got = [t.numpy() for t in batched_hungarian(torch.tensor(cost), *masks)]
    jmasks = [None if m is None else jnp.asarray(m) for m in (row_mask, col_mask)]
    want = [np.asarray(t) for t in j_batched_hungarian(jnp.asarray(cost), *jmasks)]
    return got, want


@pytest.mark.parametrize("n,m", [(7, 7), (5, 9), (9, 5)])
def test_single_nan_entry_matches_jax(n, m):
    """One NaN entry per problem (``cur < minv`` is false for it, so it never
    enters minv): the plain loop's answer is pinned against JAX's."""
    rng = np.random.default_rng(n * 10 + m)
    cost = rng.normal(size=(4, n, m)).astype(np.float32)
    for b in range(4):
        cost[b, rng.integers(n), rng.integers(m)] = np.nan
    (r2c, c2r), (j_r2c, j_c2r) = _jax_pair(cost)
    np.testing.assert_array_equal(r2c, j_r2c)
    np.testing.assert_array_equal(c2r, j_c2r)
    assert (r2c >= 0).sum() == 4 * min(n, m)


@pytest.mark.parametrize("n,m", [(6, 6), (4, 10), (10, 4)])
def test_all_ties_matches_jax(n, m):
    """Every cost equal: each search step's argmin is a tie over all
    available columns, resolved to the lowest (the first minimum)."""
    cost = np.full((2, n, m), 0.25, np.float32)
    (r2c, c2r), (j_r2c, j_c2r) = _jax_pair(cost)
    np.testing.assert_array_equal(r2c, j_r2c)
    np.testing.assert_array_equal(c2r, j_c2r)
    assert sorted(c2r[0][c2r[0] >= 0].tolist()) == list(range(min(n, m)))


def test_widest_problem_matches_scipy_and_jax():
    """m = SHORT_COLS = 256, the first CUDA instance's limit, with padded
    columns."""
    rng = np.random.default_rng(256)
    cost = rng.normal(size=(2, 12, SHORT_COLS)).astype(np.float32)
    col_mask = np.ones((2, SHORT_COLS), bool)
    col_mask[1, 200:] = False
    (r2c, c2r), (j_r2c, j_c2r) = _jax_pair(cost, None, col_mask)
    np.testing.assert_array_equal(r2c, j_r2c)
    np.testing.assert_array_equal(c2r, j_c2r)
    for b in range(2):
        cols = np.flatnonzero(col_mask[b])
        ri, ci = linear_sum_assignment(cost[b][:, cols])
        np.testing.assert_array_equal(r2c[b][ri], cols[ci])


@pytest.mark.parametrize("seed", range(5))
def test_tall_problem_with_unassigned_column_returns(seed):
    """n > m with an all-NaN column: the transposed solve leaves that column
    (a row of the inner problem) unassigned, -1, which is dropped as JAX's
    scatter with mode="drop" drops it, not written to row -1 (which raised
    ``index -1 is out of bounds``). Nothing refers to the NaN column, each
    assigned column appears once, and col2row inverts row2col."""
    cost = np.random.default_rng(seed).normal(size=(2, 6, 4)).astype(np.float32)
    cost[:, :, 2] = np.nan
    r2c, c2r = (t.numpy() for t in batched_hungarian(torch.tensor(cost)))
    for b in range(2):
        assigned = r2c[b][r2c[b] >= 0]
        assert len(set(assigned.tolist())) == len(assigned) >= 2
        assert 2 not in assigned and c2r[b, 2] == -1
        for r, c in enumerate(r2c[b]):
            if c >= 0:
                assert c2r[b, c] == r
        assert sorted(c2r[b][c2r[b] >= 0].tolist()) == np.flatnonzero(r2c[b] >= 0).tolist()


@pytest.mark.parametrize("n, m, integer", [(6, 300, False), (4, 1000, False), (300, 6, False),
                                           (6, 300, True), (64, 2000, False)],
                         ids=["6x300", "4x1000", "300x6", "6x300-ties", "64x2000"])
def test_long_problems_match_scipy_and_jax(n, m, integer):
    """Problems longer than the first CUDA instance takes (m > SHORT_COLS,
    as given or after the n > m transpose): the plain loop, which the long
    instance is held to, against JAX (ties included) and scipy (unique
    optimum), padded rows and columns in the batch. 64 x 2000 is the shape
    of the detection-only loss's encoder matcher (64 GT boxes against the
    proposals) at a smaller plane."""
    cost, row_mask, col_mask = _problems(n, m, seed=n + 3 * m, integer=integer)
    (r2c, c2r), (j_r2c, j_c2r) = _jax_pair(cost, row_mask, col_mask)
    np.testing.assert_array_equal(r2c, j_r2c)
    np.testing.assert_array_equal(c2r, j_c2r)
    if integer:
        return
    for b in range(cost.shape[0]):
        rows, cols = np.flatnonzero(row_mask[b]), np.flatnonzero(col_mask[b])
        ri, ci = linear_sum_assignment(cost[b][np.ix_(rows, cols)])
        want = np.full(n, -1)
        want[rows[ri]] = cols[ci]
        np.testing.assert_array_equal(r2c[b], want, err_msg=f"problem {b}")


def test_instance_limits():
    """The two CUDA instances' limits on m: 256 and 65,536 (the encoder's
    37,485 proposals at 1344x1344 with 4 levels fit)."""
    assert SHORT_COLS == 256 and MAX_COLS == 65536 >= 37485


@pytest.mark.cuda
@pytest.mark.parametrize("B, n, m", [(2, 6, 300), (2, 64, 22323)])
def test_long_instance_on_the_card_matches_plain(B, n, m):
    """The long CUDA instance (one launch, no host sync) against the plain
    loop, bit for bit: a tall problem and the encoder matcher's 64 x 22,323
    at 800x1344."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cost, row_mask, col_mask = _problems(n, m, seed=B * n + m, integer=False, B=B)
    on_card = [torch.tensor(a, device="cuda") for a in (cost, row_mask, col_mask)]
    launches, long_launches = batched_hungarian.launches, batched_hungarian.long_launches
    syncs = batched_hungarian.syncs
    got = batched_hungarian(*on_card)
    torch.cuda.synchronize()
    assert batched_hungarian.syncs == syncs
    assert batched_hungarian.launches == launches + 1
    assert batched_hungarian.long_launches == long_launches + 1
    want = batched_hungarian_plain(*(torch.tensor(a) for a in (cost, row_mask, col_mask)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
