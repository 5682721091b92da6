"""Batched Hungarian (linear sum assignment) on the device.

Counterpart of ``pairnet_tpu/ops/hungarian.py``: the Jonker-Volgenant
shortest-augmenting-path algorithm, with the same padding contract
(``PAD_COST``, costs clipped to +-PAD_COST/4) and the same tie order (the
first minimum: ``torch.argmin`` returns the first, as ``jnp.argmin`` does).

The JAX solver is a ``while_loop`` under ``jit``/``vmap`` that never comes
back to the host. Its counterpart here is ``csrc/hungarian.cu``, launched
on the current stream, no host sync, in two instances picked by m, the
longer side of a problem:

* m <= ``SHORT_COLS`` (256): one warp solves, each lane holding a
  contiguous slice of the columns and their state in registers; the lane
  that wins a search step sends the next row and its potential with it
  (the matchers of the decoder queries);
* ``SHORT_COLS`` < m <= ``MAX_COLS`` (65,536): a thread-block cluster of
  up to 16 CTAs a problem, each with a slice of the columns and their
  state in its shared memory, one cluster barrier a search step (the
  detection-only loss's encoder matcher: S proposals against the GT
  boxes).

On CUDA tensors :func:`batched_hungarian` launches one of them
(``batched_hungarian.launches``) or raises, for more than ``MAX_COLS``
columns, a failed build or a launch error; the preparation (clip, pad) and
the post-processing (transpose back, strip pad matches) are torch ops that
do not sync either.

The plain version, :func:`solve_n_le_m_plain`, is the same algorithm as a
loop of torch ops over the batch. CPU tensors take it; it runs on any
device. A problem whose search has ended keeps its state (masked updates)
while the others go on, as the JAX ``vmap`` does. Its search loop ends on
a device flag that the host reads, one sync per search step of the
longest search in the batch, counted in ``batched_hungarian.syncs``. The
augmenting walk needs none: its path is no longer than the search that
built it, so it runs that many masked steps.

Each call is the span ``hungarian`` (``utils/tracing.py``); while tracing
is on, ``batched_hungarian.steps`` sums the search steps of every problem
solved, on the device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pairnet_torch.ops import _build
from pairnet_torch.utils import tracing

_INF = 1e18
PAD_COST = 1e6
SHORT_COLS = 256  # the first instance's limit on m, the longer side of a problem
MAX_COLS = 65536  # the long instance's limit on m
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = _build.load("hungarian")
    lib.hungarian_solve.argtypes = [_P, _P, _P, _I, _I, _I, _P]
    lib.hungarian_solve.restype = ctypes.c_int
    lib.hungarian_solve_long.argtypes = [_P, _P, _P, _I, _I, _I, _P, _P]
    lib.hungarian_solve_long.restype = ctypes.c_int
    lib.hungarian_long_workspace.argtypes = [_I, _I]
    lib.hungarian_long_workspace.restype = ctypes.c_longlong
    lib.hungarian_long_cluster.argtypes = [_I]
    lib.hungarian_long_cluster.restype = ctypes.c_int
    return lib


def solve_n_le_m_plain(cost):
    """JV on a batch of (n, m) cost matrices, n <= m, f32. Returns row2col
    (B, n): the assigned column of every row (always valid since n <= m)."""
    return solve_n_le_m_plain_steps(cost)[0]


def solve_n_le_m_plain_steps(cost):
    """:func:`solve_n_le_m_plain` with the search steps each problem took
    over all its rows, int32 (B,), as :func:`solve_n_le_m_cuda` returns
    them: (row2col, steps)."""
    B, n, m = cost.shape
    dev = cost.device
    bidx = torch.arange(B, device=dev)
    u = cost.new_zeros((B, n))
    v = cost.new_zeros((B, m + 1))
    # p[j] = row assigned to column j (-1 free); column m is the virtual
    # start column that holds the row being inserted
    p = torch.full((B, m + 1), -1, dtype=torch.long, device=dev)
    inf = cost.new_tensor(_INF)
    steps_b = torch.zeros((B,), dtype=torch.int32, device=dev)
    for i in range(n):
        p[:, m] = i
        way = torch.zeros((B, m), dtype=torch.long, device=dev)
        minv = torch.full((B, m), _INF, dtype=cost.dtype, device=dev)
        used = torch.zeros((B, m + 1), dtype=torch.bool, device=dev)
        row_used = torch.zeros((B, n), dtype=torch.bool, device=dev)
        j0 = torch.full((B,), m, dtype=torch.long, device=dev)
        active = torch.ones((B,), dtype=torch.bool, device=dev)  # p[j0] != -1
        steps = 0
        while True:
            a = active[:, None]
            steps_b += active.int()
            used_n = used.clone()
            used_n[bidx, j0] = True
            i0 = p[bidx, j0]
            row_used_n = row_used.clone()
            row_used_n[bidx, i0.clamp_min(0)] = True
            cur = cost[bidx, i0.clamp_min(0)] - u[bidx, i0.clamp_min(0)][:, None] - v[:, :m]
            avail = ~used_n[:, :m]
            better = (cur < minv) & avail
            minv_n = torch.where(better, cur, minv)
            way_n = torch.where(better, j0[:, None], way)
            masked = torch.where(avail, minv_n, inf)
            j1 = torch.argmin(masked, dim=1)
            delta = masked[bidx, j1][:, None]
            u_n = u + torch.where(row_used_n, delta, 0.0)
            v_n = v - torch.where(used_n, delta, 0.0)
            minv_n = torch.where(avail, minv_n - delta, minv_n)
            used = torch.where(a, used_n, used)
            row_used = torch.where(a, row_used_n, row_used)
            minv = torch.where(a, minv_n, minv)
            way = torch.where(a, way_n, way)
            u = torch.where(a, u_n, u)
            v = torch.where(a, v_n, v)
            j0 = torch.where(active, j1, j0)
            steps += 1
            active = p[bidx, j0] != -1
            batched_hungarian.syncs += 1
            if not bool(active.any()):
                break
        # augment: walk `way` back to the virtual column, shifting matches;
        # a path has at most `steps` links
        for _ in range(steps):
            go = j0 != m
            j1 = torch.where(go, way[bidx, j0.clamp_max(m - 1)], j0)
            p_n = p.clone()
            p_n[bidx, j0] = p[bidx, j1]
            p = torch.where(go[:, None], p_n, p)
            j0 = j1
        p[:, m] = -1
    # invert p (col -> row) into row2col
    row2col = torch.full((B, n + 1), -1, dtype=torch.long, device=dev)
    valid = p[:, :m] >= 0
    cols = torch.arange(m, device=dev).expand(B, m)
    row2col.scatter_(1, torch.where(valid, p[:, :m], n), torch.where(valid, cols, -1))
    return row2col[:, :n], steps_b


def solve_n_le_m_cuda(cost):
    """The kernel on a batch of (n, m) f32 cost matrices on the card, n <=
    m <= ``MAX_COLS`` (the long instance above ``SHORT_COLS``): (row2col
    int64 (B, n), steps int32 (B,), the search steps each problem took)."""
    B, n, m = cost.shape
    if not 1 <= n <= m <= MAX_COLS:
        raise ValueError(f"hungarian kernel: takes 1 <= n <= m <= {MAX_COLS}, not n={n}, m={m}")
    if cost.dtype != torch.float32:
        raise TypeError(f"hungarian kernel: f32 costs, not {cost.dtype}")
    cost = cost.contiguous()
    row2col = torch.empty((B, n), dtype=torch.long, device=cost.device)
    steps = torch.empty((B,), dtype=torch.int32, device=cost.device)
    if B == 0:
        return row2col, steps
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream().cuda_stream
        if m <= SHORT_COLS:
            status = _lib().hungarian_solve(cost.data_ptr(), row2col.data_ptr(),
                                            steps.data_ptr(), B, n, m, stream)
        else:  # the long instance; u and its spilled search winners in a workspace
            ws = torch.empty((B * _lib().hungarian_long_workspace(n, m),), dtype=torch.int32,
                             device=cost.device)
            status = _lib().hungarian_solve_long(cost.data_ptr(), row2col.data_ptr(),
                                                 steps.data_ptr(), B, n, m, ws.data_ptr(), stream)
    _build.check(status, "hungarian")
    batched_hungarian.launches += 1
    if m > SHORT_COLS:
        batched_hungarian.long_launches += 1
    return row2col, steps


def long_cluster(m: int) -> int:
    """CTAs a problem of m columns gets from the long instance on the
    current card (its cluster size), 0 if no cluster fits."""
    return _lib().hungarian_long_cluster(m)


def _solve_n_le_m(cost):
    """The kernel for CUDA tensors, the plain loop for CPU tensors. While
    tracing is on, adds the problems' search steps to
    ``batched_hungarian.steps`` on the device (no host sync)."""
    if cost.device.type == "cpu":
        row2col, steps = solve_n_le_m_plain_steps(cost)
    elif cost.device.type == "cuda":
        row2col, steps = solve_n_le_m_cuda(cost)
    else:
        raise ValueError(f"batched_hungarian: unsupported device {cost.device}")
    if tracing.enabled():
        batched_hungarian.steps = batched_hungarian.steps + steps.sum(dtype=torch.int64)
    return row2col


def prepare(cost, row_mask=None, col_mask=None):
    """The f32 costs the solver sees: ``cost`` (B, n, m) clipped to
    +-PAD_COST/4, padded rows and columns set to ``PAD_COST``, transposed
    to (B, m, n) when n > m so that the solver's rows never outnumber its
    columns. Returns (costs, row_mask, col_mask), the masks filled in."""
    B, n, m = cost.shape
    if row_mask is None:
        row_mask = torch.ones((B, n), dtype=torch.bool, device=cost.device)
    if col_mask is None:
        col_mask = torch.ones((B, m), dtype=torch.bool, device=cost.device)
    cost = cost.float().clamp(-PAD_COST / 4, PAD_COST / 4)
    cost = torch.where(col_mask[:, None, :], cost, PAD_COST)
    cost = torch.where(row_mask[:, :, None], cost, PAD_COST)
    if n > m:
        cost = cost.transpose(1, 2).contiguous()
    return cost, row_mask, col_mask


def _assign(solve, cost, row_mask, col_mask):
    B, n, m = cost.shape
    dev = cost.device
    cost, row_mask, col_mask = prepare(cost, row_mask, col_mask)
    if n <= m:
        row2col = solve(cost)
    else:
        col2row_full = solve(cost)  # (B, m), < n
        # a column the inner solve left unassigned (-1) is dropped, as JAX's
        # scatter with mode="drop" drops it
        row2col = torch.full((B, n + 1), -1, dtype=torch.long, device=dev)
        row2col.scatter_(1, torch.where(col2row_full >= 0, col2row_full, n),
                         torch.arange(m, device=dev).expand(B, m))
        row2col = row2col[:, :n]
    # strip pad-pad matches: a valid row matched to an invalid column (or
    # vice versa) is reported unmatched
    col_ok = torch.gather(col_mask, 1, row2col.clamp(0, m - 1))
    cols_ok = torch.where((row2col >= 0) & row_mask & col_ok, row2col, -1)
    col2row = torch.full((B, m + 1), -1, dtype=torch.long, device=dev)
    rows = torch.arange(n, device=dev).expand(B, n)
    col2row.scatter_(1, torch.where(cols_ok >= 0, cols_ok, m), torch.where(cols_ok >= 0, rows, -1))
    return cols_ok, col2row[:, :m]


def batched_hungarian(cost, row_mask=None, col_mask=None):
    """Solve B (n, m) assignment problems on the device.

    cost (B, n, m); masks (B, n) / (B, m) bool or None. Masked (padded) rows
    and columns never match a valid counterpart. Returns ``(row2col (B, n),
    col2row (B, m))``, int64 with -1 for unassigned or invalid. Matches
    ``scipy.optimize.linear_sum_assignment`` on each valid submatrix.
    """
    with tracing.span("hungarian"):
        return _assign(_solve_n_le_m, cost, row_mask, col_mask)


def batched_hungarian_plain(cost, row_mask=None, col_mask=None):
    """Plain version of :func:`batched_hungarian` on any device: the same
    preparation and post-processing around :func:`solve_n_le_m_plain`."""
    return _assign(solve_n_le_m_plain, cost, row_mask, col_mask)


batched_hungarian.syncs = 0
batched_hungarian.launches = 0  # both instances
batched_hungarian.long_launches = 0  # the long instance's
batched_hungarian.steps = 0  # search steps while tracing, a device tensor once counted
