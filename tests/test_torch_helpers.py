"""Shared helpers of the PyTorch port's parity tests (``tests/test_torch_*.py``).

Inputs and noise come from numpy seeds and reach both packages as numpy
arrays. Holds no tests itself.
"""

import numpy as np

MSDA_SHAPES = ((20, 30), (10, 15), (5, 8))
TINY_SPLIT = {"num_images": 8, "num_test": 3, "seed": 1}  # tiny_synthetic's fixture


def jax_dataset(port_dataset_root, split):
    """The JAX package's PSGDataset on the port's synthetic fixture (the same
    files for both packages; the fixtures' equality is tested on its own)."""
    from pairnet_tpu.data.psg import PSGDataset

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
