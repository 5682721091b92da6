"""Batched Hungarian (linear sum assignment) on the device.

Counterpart of ``pairnet_tpu/ops/hungarian.py``: the Jonker-Volgenant
shortest-augmenting-path algorithm, with the same padding contract
(``PAD_COST``, costs clipped to +-PAD_COST/4) and the same tie order (the
first minimum: ``torch.argmin`` returns the first, as ``jnp.argmin`` does).
The B problems of a step are solved together, as the JAX ``vmap`` of its
``while_loop``s does: a problem whose loop has ended keeps its state
(masked updates) while the others go on.

The search loop for a row ends on a device flag that the host reads: one
host sync per iteration of the longest search in the batch. The augmenting
walk needs none, because its path is no longer than the search that built
it, so it runs that many masked steps. ``batched_hungarian.syncs`` counts
the host syncs.
"""

from __future__ import annotations

import torch

_INF = 1e18
PAD_COST = 1e6


def _solve_n_le_m(cost):
    """JV on a batch of (n, m) cost matrices, n <= m, f32. Returns row2col
    (B, n): the assigned column of every row (always valid since n <= m)."""
    B, n, m = cost.shape
    dev = cost.device
    bidx = torch.arange(B, device=dev)
    u = cost.new_zeros((B, n))
    v = cost.new_zeros((B, m + 1))
    # p[j] = row assigned to column j (-1 free); column m is the virtual
    # start column that holds the row being inserted
    p = torch.full((B, m + 1), -1, dtype=torch.long, device=dev)
    inf = cost.new_tensor(_INF)
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
    return row2col[:, :n]


def batched_hungarian(cost, row_mask=None, col_mask=None):
    """Solve B (n, m) assignment problems on the device.

    cost (B, n, m); masks (B, n) / (B, m) bool or None. Masked (padded) rows
    and columns never match a valid counterpart. Returns ``(row2col (B, n),
    col2row (B, m))``, int64 with -1 for unassigned or invalid. Matches
    ``scipy.optimize.linear_sum_assignment`` on each valid submatrix.
    """
    B, n, m = cost.shape
    dev = cost.device
    if row_mask is None:
        row_mask = torch.ones((B, n), dtype=torch.bool, device=dev)
    if col_mask is None:
        col_mask = torch.ones((B, m), dtype=torch.bool, device=dev)
    # clip to a sane range, then overwrite padded entries with the constant
    cost = cost.float().clamp(-PAD_COST / 4, PAD_COST / 4)
    cost = torch.where(col_mask[:, None, :], cost, PAD_COST)
    cost = torch.where(row_mask[:, :, None], cost, PAD_COST)
    if n <= m:
        row2col = _solve_n_le_m(cost)
    else:
        col2row_full = _solve_n_le_m(cost.transpose(1, 2).contiguous())  # (B, m), < n
        row2col = torch.full((B, n), -1, dtype=torch.long, device=dev)
        row2col.scatter_(1, col2row_full, torch.arange(m, device=dev).expand(B, m))
    # strip pad-pad matches: a valid row matched to an invalid column (or
    # vice versa) is reported unmatched
    col_ok = torch.gather(col_mask, 1, row2col.clamp(0, m - 1))
    cols_ok = torch.where((row2col >= 0) & row_mask & col_ok, row2col, -1)
    col2row = torch.full((B, m + 1), -1, dtype=torch.long, device=dev)
    rows = torch.arange(n, device=dev).expand(B, n)
    col2row.scatter_(1, torch.where(cols_ok >= 0, cols_ok, m), torch.where(cols_ok >= 0, rows, -1))
    return cols_ok, col2row[:, :m]


batched_hungarian.syncs = 0
