"""The designs of the hand-written loop kernels, modelled in numpy on the CPU.

``csrc/nms.cu`` computes a pairwise suppression bitmask (64-bit words,
upper triangle only), then sweeps it one 64-box block at a time: a block's
diagonal word resolved bit by bit, its kept rows OR-ed into the later
words. The model here follows the kernel's words, bits and order, and is
held equal to the plain sweep (``nms_sorted_plain``) and to JAX's
``nms`` / ``batched_nms``: score ties, pairs at IoU exactly 0.5 and 0.7,
invalid entries, class offsets, N = 1, 63, 64, 65 and 300.

``csrc/hungarian.cu``'s long instance splits the columns over the CTAs
of a cluster: each thread's first least, each warp's least (order_key,
column), each CTA's least over its 8 warps, then a merge over the K CTAs'
slots. The merge is held equal to
``torch.argmin`` (ties, -0 and +0, slices masked whole at 1e18, m not a
multiple of K). The whole search is modelled too, with the kernel's
bookkeeping (way kept as a search step, the winners of a search recorded,
u and v updated once at its end, the augmenting path walked from the
winners, the plain walk for a degenerate search), and held equal to the
plain loop's assignments and search steps, NaN entries and whole NaN rows
included.

Its short instance (m <= 256) is one warp: lane l owns the contiguous
columns [(31 - l) S, (32 - l) S), so the first minimum is in the highest
lane holding the least key; the winner's lane sends the next row with its potential
(u carried with the column that holds the row, updated step by step); the
path is walked from a winners list. That search is modelled too and held
to the plain loop's assignments and search steps for m on both sides of
each slot count, NaN entries and rows, and the padded 100 x 100 problem
of 5,050 steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.ops import nms as j_nms
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.ops import hungarian, nms  # noqa: E402
from pairnet_torch.ops.boxes import box_iou  # noqa: E402

F32 = np.float32
BITS = 64
ALL = (1 << BITS) - 1
INF = F32(1e18)  # the Hungarian loop's _INF
LANES, THREADS = 32, 256  # the long instance's warps and CTA


# --- NMS: bitmask, then a block-wise sweep ---

def nms_boxes(seed, n):
    """Boxes (2, n, 4) in a 200 x 200 image, scores (2, n), valid (2, n) and
    80-class labels (2, n): every third score repeats its predecessor's, a
    10 x 10 box with its 10 x 5 (IoU 0.5) and 10 x 7 (IoU 0.7) parts
    planted, a fifth invalid."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 160, (2, n, 2))
    wh = rng.uniform(4, 60, (2, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(F32)
    for i in range(0, n - 2, 7):
        x, y = np.floor(xy[:, i]).T.astype(F32)
        boxes[:, i] = np.stack([x, y, x + 10, y + 10], -1)
        boxes[:, i + 1] = np.stack([x, y, x + 10, y + 5], -1)
        boxes[:, i + 2] = np.stack([x, y, x + 10, y + 7], -1)
    scores = rng.random((2, n)).astype(F32)
    scores[:, 2::3] = scores[:, 1::3][:, : scores[:, 2::3].shape[1]]
    valid = rng.random((2, n)) > 0.2
    labels = rng.integers(0, 80, (2, n)).astype(np.int32)
    return boxes, scores, valid, labels


def suppression_words(boxes, thr, rng):
    """The mask kernel's output for sorted boxes (B, N, 4): word w of row i
    has bit c set when j = 64 w + c > i and IoU(i, j) > thr, for w >= i's
    block; the lower triangle, which the kernel never writes, is garbage."""
    B, N, _ = boxes.shape
    W = -(-N // BITS)
    over = (box_iou(torch.tensor(boxes), torch.tensor(boxes))[0] > thr).numpy()
    words = rng.integers(0, 2 ** 63, (B, N, W), dtype=np.int64).astype(object)
    for b in range(B):
        for i in range(N):
            for w in range(i // BITS, W):
                bits = 0
                for c in range(BITS):
                    j = w * BITS + c
                    if i < j < N and over[b, i, j]:
                        bits |= 1 << c
                words[b, i, w] = bits
    return words


def block_sweep(words, valid):
    """The sweep kernel on one image: (keep (N,), rounds a block). Removed
    bits start at ~valid with the bits past N set; each block's kept boxes
    are the fixed point of kept = cand & ~OR(diagonal words of the kept
    rows), by rounds from kept = cand; then its kept rows' later words are
    OR-ed in by four row groups of 16."""
    N, W = words.shape
    removed = []
    for w in range(W):
        r = 0
        for c in range(BITS):
            i = w * BITS + c
            if i >= N or not valid[i]:
                r |= 1 << c
        removed.append(r)
    diag = [int(words[i, i // BITS]) for i in range(N)]
    diag += [0] * (W * BITS - N)
    keep = np.zeros(N, bool)
    rounds = []
    for rb in range(W):
        cand = ~removed[rb] & ALL
        kept = cand
        for r in range(BITS):
            supp = 0
            for k in range(BITS):
                if (kept >> k) & 1:
                    supp |= diag[rb * BITS + k]
            now = cand & ~supp
            if now == kept:
                break
            kept = now
        rounds.append(r + 1)
        lim = min(BITS, N - rb * BITS)
        for k in range(lim):
            keep[rb * BITS + k] = (kept >> k) & 1
        for w in range(rb + 1, W):
            for g in range(4):
                acc = 0
                for r in range(16):
                    i = rb * BITS + 16 * g + r
                    if (kept >> (16 * g + r)) & 1:
                        acc |= int(words[i, w])
                removed[w] |= acc
    return keep, rounds


@pytest.mark.parametrize("offset", [False, True], ids=["boxes", "class_offsets"])
@pytest.mark.parametrize("thr", [0.5, 0.7])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 300])
def test_nms_bitmask_sweep_model(n, thr, offset):
    """The bitmask + block-wise sweep keeps what the plain sweep and JAX's
    greedy NMS (``batched_nms`` with class offsets) keep: a barrier for each
    64-box block, each block's diagonal settled in at most 64 rounds."""
    boxes, scores, valid, labels = nms_boxes(n + int(10 * thr), n)
    t = torch.tensor(boxes)
    if offset:  # as batched_nms moves each image's boxes
        t = t + torch.tensor(labels).float()[..., None] * (
            2.0 * (t.abs().amax(dim=(-2, -1), keepdim=True) + 1.0))
    order = nms.score_order(torch.tensor(scores), torch.tensor(valid))
    sb = torch.gather(t, 1, order[..., None].expand(-1, -1, 4))
    sv = torch.gather(torch.tensor(valid), 1, order)
    words = suppression_words(sb.numpy(), thr, np.random.default_rng(n))
    swept = [block_sweep(words[b], sv[b].numpy()) for b in range(2)]
    keep_sorted = np.stack([k for k, _ in swept])
    np.testing.assert_array_equal(keep_sorted, nms.nms_sorted_plain(sb, sv, thr).numpy())
    keep = np.zeros_like(keep_sorted)
    np.put_along_axis(keep, order.numpy(), keep_sorted, 1)
    for b in range(2):
        args = [jnp.asarray(boxes[b]), jnp.asarray(scores[b])]
        want = (j_nms.batched_nms(*args, jnp.asarray(labels[b]), thr, jnp.asarray(valid[b]))
                if offset else j_nms.nms(*args, thr, jnp.asarray(valid[b])))
        np.testing.assert_array_equal(keep[b], np.asarray(want))
        rounds = swept[b][1]
        assert len(rounds) == -(-n // BITS) and max(rounds) <= BITS


def test_nms_diagonal_rounds_on_a_chain():
    """A block whose 64 boxes each overlap the next (a chain of
    suppressions: 0 keeps, 1 goes, 2 keeps, ...) settles in the most rounds
    and still keeps the greedy sweep's boxes: every other one."""
    x = np.arange(64, dtype=F32) * 5
    boxes = np.stack([x, np.zeros(64, F32), x + 10, np.full(64, 10, F32)], -1)[None]
    valid = np.ones((1, 64), bool)
    words = suppression_words(boxes, 0.3, np.random.default_rng(0))
    keep, rounds = block_sweep(words[0], valid[0])
    want = nms.nms_sorted_plain(torch.tensor(boxes), torch.tensor(valid), 0.3)[0].numpy()
    np.testing.assert_array_equal(keep, want)
    np.testing.assert_array_equal(keep, np.arange(64) % 2 == 0)
    assert rounds == [BITS]


# --- the long Hungarian instance: sliced first minimum, then the search ---

def order_key(x):
    """The kernel's order_key: the IEEE order of f32 ``x`` as uint32, -0 = +0."""
    x = np.asarray(x, F32)
    b = np.where(x == 0, F32(0), x).astype(F32).view(np.uint32)
    return np.where(b & np.uint32(1 << 31), ~b, b | np.uint32(1 << 31)).astype(np.uint32)


def sliced_first_min(masked, K, threads=THREADS, lanes=LANES):
    """The long instance's argmin over ``masked`` (m,) f32: CTA r owns
    columns [r cs, (r + 1) cs), cs = ceil(m / K); its thread t the columns
    t, t + threads, ...; each thread's first least value, each warp's least
    (key, column) pair, the CTA's least over its warps (its slot), then the
    least over the K slots. Returns (column, value)."""
    m = masked.shape[0]
    cs = -(-m // K)
    keys = order_key(masked).astype(np.int64)
    slots = []
    for r in range(K):
        base, cnt = r * cs, max(0, min(cs, m - r * cs))
        nk = -(-cnt // threads) if cnt else 0
        grid = np.full((max(nk, 1), threads), 2 ** 33, np.int64)  # no column: above every key
        grid.reshape(-1)[:cnt] = keys[base:base + cnt]
        first = np.argmin(grid, axis=0)  # each thread's first least
        tkey = grid[first, np.arange(threads)]
        tcol = base + first * threads + np.arange(threads)
        warps = []
        for w in range(threads // lanes):
            lk, lc = tkey[w * lanes:(w + 1) * lanes], tcol[w * lanes:(w + 1) * lanes]
            least = lk.min()
            if least < 2 ** 33:
                warps.append((least, lc[lk == least].min()))
        if warps:
            slots.append(min(warps))
    _, col = min(slots)
    return int(col), masked[col]


@pytest.mark.parametrize("K", [2, 8, 16])
@pytest.mark.parametrize("m, kind", [(257, "ties"), (257, "zeros"), (1000, "masked_slices"),
                                     (4099, "ties"), (22323, "normal")])
def test_sliced_first_minimum_merge(m, kind, K):
    """The merge over K column slices picks torch.argmin's column (the
    first least) and its value bit for bit: integer ties, -0 and +0 mixed
    at the least, whole slices masked at 1e18, m not a multiple of K."""
    rng = np.random.default_rng(m + K)
    if kind == "ties":
        masked = rng.integers(0, 3, m).astype(F32)
    elif kind == "zeros":
        masked = rng.integers(0, 3, m).astype(F32)
        masked[masked == 0] = np.where(rng.random(int((masked == 0).sum())) < 0.5, F32(-0.0),
                                       F32(0.0))
    elif kind == "masked_slices":
        masked = rng.normal(size=m).astype(F32) + F32(5)
        cs = -(-m // K)
        masked[:cs * (K // 2)] = INF  # the first half of the slices used up
        masked[-1] = masked[-2] = masked.min()  # a tie in the last, ragged slice
    else:
        masked = rng.normal(size=m).astype(F32)
    col, val = sliced_first_min(masked, K)
    want = int(torch.argmin(torch.tensor(masked)))
    assert col == want
    assert np.float32(val).tobytes() == masked[want].tobytes()
    if kind == "zeros":
        assert masked[want] == 0


def cluster_solve(cost, K, threads=8, lanes=4):
    """The long instance's search on one (n, m) problem: (row2col, search
    steps). Per step the pass over the columns (minv -= the previous delta,
    cur < minv, way = the step), the sliced first minimum, the winner
    (column, delta, p, way) recorded; at the end of a search the path
    walked from the winners (the plain walk when a way was never set or a
    used column won), then v and u updated as the plain loop does step by
    step, each entry adding the same deltas in order."""
    n, m = cost.shape
    minv, way = np.full(m, INF, F32), np.full(m, -1, np.int64)
    v, p, used = np.zeros(m, F32), np.full(m, -1, np.int64), np.zeros(m, bool)
    u = np.zeros(n, F32)
    total, dup = 0, False
    for i in range(n):
        i0, steps, pending, wins = i, 0, F32(0), []
        scan = dup
        while True:
            ui0 = u[i0]
            rows = [i] + [w[2] for w in wins[:steps - 1]]
            if scan and steps > 0 and i0 in rows:  # a row visited again (degenerate)
                for t in range(rows.index(i0), steps - 1):
                    ui0 = F32(ui0 + wins[t][1])
                ui0 = F32(ui0 + pending)
            avail = ~used
            if steps == 0:
                mv, wv = np.full(m, INF, F32), np.full(m, -1, np.int64)
            else:
                mv, wv = (minv - pending).astype(F32), way.copy()
            cur = ((cost[i0] - ui0).astype(F32) - v).astype(F32)
            better = avail & (cur < mv)
            minv = np.where(avail, np.where(better, cur, mv), minv).astype(F32)
            way = np.where(avail, np.where(better, steps, wv), way)
            j1, delta = sliced_first_min(np.where(avail, minv, INF).astype(F32), K, threads, lanes)
            wins.append((j1, F32(delta), int(p[j1]), -2 if used[j1] else int(way[j1])))
            used[j1] = True
            scan = scan or wins[-1][3] < 0
            pending = F32(delta)
            steps += 1
            i0 = wins[-1][2]
            if i0 == -1 or steps > m:
                break
        if any(w[3] < 0 for w in wins) or steps > m:  # the plain loop's walk
            j = wins[-1][0]
            for _ in range(steps):
                if j == m:
                    break
                w = int(way[j])
                jn = 0 if w < 0 else (m if w == 0 else wins[w - 1][0])
                p[j] = i if jn == m else p[jn]
                j = jn
            dup = True
        else:  # from the winners: p[c_t] = the row step way(c_t) visited
            t = steps
            while t:
                c, _, _, w = wins[t - 1]
                p[c] = i if w == 0 else wins[w - 1][2]
                t = w
        rows = [i] + [w[2] for w in wins[:steps - 1]]
        for t in range(1, steps):
            c = wins[t - 1][0]
            if not (scan and c in [w[0] for w in wins[:t - 1]]):
                for s in range(t, steps):
                    v[c] = F32(v[c] - wins[s][1])
        for t in range(steps):
            if not (scan and rows[t] in rows[:t]):
                for s in range(t, steps):
                    u[rows[t]] = F32(u[rows[t]] + wins[s][1])
        used[[w[0] for w in wins]] = False
        total += steps
    row2col = np.full(n, -1, np.int64)
    for j in range(m):
        if p[j] >= 0:
            row2col[p[j]] = max(row2col[p[j]], j)
    return row2col, total


@pytest.mark.parametrize("K", [2, 3, 5])
@pytest.mark.parametrize("kind", ["normal", "ties", "nan_entry", "nan_row", "nan_scattered"])
def test_cluster_search_model_matches_plain_loop(kind, K):
    """The long instance's bookkeeping gives the plain loop's assignments
    and search steps: 12 problems each, square and wide, integer ties, a
    NaN entry, a whole NaN row, a third of the costs NaN."""
    rng = np.random.default_rng(K * 100 + len(kind))
    for _ in range(12):
        n = int(rng.integers(1, 9))
        m = int(rng.integers(n, 30))
        cost = (rng.integers(0, 4, (n, m)) if kind == "ties"
                else rng.normal(size=(n, m))).astype(F32)
        if kind == "nan_entry":
            cost[n // 2, m // 3] = np.nan
        elif kind == "nan_row":
            cost[n // 2] = np.nan
        elif kind == "nan_scattered":
            cost[rng.random((n, m)) < 0.3] = np.nan
        got, steps = cluster_solve(cost, K)
        syncs = hungarian.batched_hungarian.syncs
        want = hungarian.solve_n_le_m_plain(torch.tensor(cost[None]))[0].numpy()
        np.testing.assert_array_equal(got, want)
        assert steps == hungarian.batched_hungarian.syncs - syncs


# --- the short Hungarian instance: one warp, contiguous columns a lane ---

def warp_slots(m):
    """Columns a lane owns in the short instance: the least of 1, 2, 4, 8
    with 32 of them covering m (m <= 256)."""
    return next(s for s in (1, 2, 4, 8) if LANES * s >= m)


def lane_first_min(masked, S, lanes=LANES):
    """Lane l owns columns [(31 - l) S, (32 - l) S), the ghosts past m at
    1e18 and never available. Each lane's least value (a min tree: -0 and
    +0 equal) and the first of its slots holding it; then the least
    order_key over the lanes (one reduction) and the highest lane holding
    it (a ballot's highest bit), whose columns come first. Returns the
    column."""
    m = masked.shape[0]
    grid = np.full(lanes * S, INF, F32)
    grid[:m] = masked
    grid = grid.reshape(lanes, S)  # row r: the columns of lane 31 - r
    lo = grid.min(axis=1)
    first = np.argmax(grid == lo[:, None], axis=1)
    keys = order_key(lo)
    holders = [lanes - 1 - r for r in np.flatnonzero(keys == keys.min())]
    r = lanes - 1 - max(holders)
    return r * S + int(first[r])


def warp_solve(cost):
    """The short instance's search on one (n, m) problem, m <= 256:
    (row2col, search steps). Between searches p and u live in shared
    memory (pS by column, uS by row); within one the column owners hold
    minv, way (as a step, -1 unset), v, p and pu = u[p] in registers, and
    the winner's lane sends delta, p and pu: the next row and its
    potential. Per step, off that chain, v -= delta and pu += delta on the
    used columns, the inserted row's ui += delta. At the end of a search
    uS takes the visited rows' u, the path is walked from the winners list
    (the plain walk after a degenerate search: a way never set, a used
    column won), and the owners reload p and pu. After a degenerate search
    two columns may hold one row, so from then on u stays per row in uS,
    every visited row adding each step's delta there."""
    n, m = cost.shape
    S = warp_slots(m)
    pS, uS = np.full(m, -1, np.int64), np.zeros(n, F32)
    v = np.zeros(m, F32)
    total, dup = 0, False
    for i in range(n):
        p = pS.copy()
        pu = np.where(p >= 0, uS[np.maximum(p, 0)], F32(0)).astype(F32)
        minv, way, used = np.full(m, INF, F32), np.full(m, -1, np.int64), np.zeros(m, bool)
        ui, i0, ui0, steps, wins, visited = F32(0), i, F32(0), 0, [], []
        while True:
            if dup:
                if i0 not in visited:
                    visited.append(i0)
                ui0 = uS[i0]
            avail = ~used
            cur = ((cost[i0] - ui0).astype(F32) - v).astype(F32)
            better = avail & (cur < minv)
            minv = np.where(better, cur, minv).astype(F32)
            way = np.where(better, steps, way)
            j1 = lane_first_min(np.where(avail, minv, INF).astype(F32), S)
            delta = np.where(avail, minv, INF)[j1]
            wins.append((j1, int(p[j1]), -2 if used[j1] else int(way[j1])))
            if dup:
                for r in visited:
                    uS[r] = F32(uS[r] + delta)
            else:
                pu = np.where(used, pu + delta, pu).astype(F32)
                ui = F32(ui + delta)
            v = np.where(used, v - delta, v).astype(F32)
            minv = np.where(avail, minv - delta, minv).astype(F32)
            used[j1] = True
            steps += 1
            i0, ui0 = wins[-1][1], pu[j1]
            if i0 == -1 or steps > m:
                break
        if not dup:
            held = used & (p >= 0)  # the last winner is free unless the search was cut
            uS[p[held]] = pu[held]
            uS[i] = ui
        if any(w[2] < 0 for w in wins) or steps > m:  # the plain walk
            j = wins[-1][0]
            for _ in range(steps):
                if j == m:
                    break
                w = int(way[j])
                jn = 0 if w < 0 else (m if w == 0 else wins[w - 1][0])
                pS[j] = i if jn == m else pS[jn]
                j = jn
            dup = True
        else:  # from the winners: p[c_t] = the row step way(c_t) visited
            t = steps
            while t:
                c, _, w = wins[t - 1]
                pS[c] = i if w == 0 else wins[w - 1][1]
                t = w
        total += steps
    row2col = np.full(n, -1, np.int64)
    for j in range(m):
        if pS[j] >= 0:
            row2col[pS[j]] = max(row2col[pS[j]], j)
    return row2col, total


def warp_case(kind, n, m, seed):
    rng = np.random.default_rng(seed)
    if kind == "padded":  # uniform costs, 3 valid columns: prepare() pads the rest
        cost = torch.tensor(rng.uniform(0, 1, (1, n, m)).astype(F32))
        return hungarian.prepare(cost, None, torch.arange(m)[None] < 3)[0][0].numpy()
    cost = (rng.integers(0, 4, (n, m)) if kind == "ties" else rng.normal(size=(n, m))).astype(F32)
    if kind == "nan_entry":
        cost[n // 2, m // 3] = np.nan
    elif kind == "nan_row":
        cost[n // 2] = np.nan
    elif kind == "nan_scattered":
        cost[rng.random((n, m)) < 1 / 3] = np.nan
    return cost


@pytest.mark.parametrize("kind, n, m", [
    *[(kind, n, m) for kind in ("normal", "ties", "nan_entry", "nan_row", "nan_scattered")
      for n, m in [(1, 1), (9, 31), (32, 32), (20, 33), (64, 64), (24, 100), (40, 128),
                   (13, 129), (12, 256)]],
    ("normal", 100, 100), ("ties", 64, 100), ("padded", 100, 100)])
def test_warp_search_model_matches_plain_loop(kind, n, m):
    """The short instance's search (contiguous columns a lane, the highest
    lane's first minimum, the potentials carried with the columns, the walk
    from the winners list, per-row potentials after a degenerate search)
    gives the plain loop's assignments and search steps: m on both sides of
    every slot count, integer ties, a NaN entry, a whole NaN row, a third
    of the costs NaN, and 100 x 100 with 3 valid columns, the padded
    matcher's worst case of 100 * 101 / 2 steps."""
    cost = warp_case(kind, n, m, seed=5 if kind == "padded" else n * 1000 + m + len(kind))
    got, steps = warp_solve(cost)
    syncs = hungarian.batched_hungarian.syncs
    want, want_steps = hungarian.solve_n_le_m_plain_steps(torch.tensor(cost[None]))
    np.testing.assert_array_equal(got, want[0].numpy())
    assert steps == int(want_steps[0]) == hungarian.batched_hungarian.syncs - syncs
    if kind == "padded":
        assert steps == 5050
