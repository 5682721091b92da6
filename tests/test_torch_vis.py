"""Port parity of the visualization: ``pairnet_torch.utils.visualize`` and
``python -m pairnet_torch.tools.vis_results`` against the JAX package's
``pairnet_tpu/utils/visualize.py`` and ``tools/vis_results.py``, which draw
with PIL. The port draws and writes without it.
"""

import importlib.util
import math
import os
import sys

import numpy as np
import pytest
from scipy.ndimage import binary_dilation

from pairnet_tpu.utils import visualize as jvis
from test_torch_helpers import TINY_SPLIT
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.data import png  # noqa: E402
from pairnet_torch.evaluation.runner import load_predictions  # noqa: E402
from pairnet_torch.tools import test as test_cli  # noqa: E402
from pairnet_torch.tools import vis_results  # noqa: E402
from pairnet_torch.train.builder import synthetic_root  # noqa: E402
from pairnet_torch.utils import visualize as pvis  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "pairnet", "tiny_synthetic.py")
CLASSES = ["ball", "box", "cat", "dog", "sky", "grass", "water"]
PREDICATES = ["on", "under", "near", "in front of", "beside"]
GRAY = (90, 90, 90)  # the edges' colour


def _triplets(seed, K=6, hw=(40, 56)):
    """Random triplets: (image, masks, labels, pairs, r_labels, r_scores),
    with one entity shared by two triplets and one empty mask."""
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, size=(*hw, 3)).astype(np.uint8)
    masks = rng.uniform(size=(2 * K, *hw)) < 0.3
    masks[1] = False
    labels = rng.integers(1, len(CLASSES) + 1, size=2 * K)
    pairs = np.stack([np.arange(K), np.arange(K) + K], 1)
    pairs[2] = pairs[0]
    r_labels = rng.integers(1, len(PREDICATES) + 1, size=K)
    r_scores = rng.uniform(size=K).astype(np.float32)
    return image, masks, labels, pairs, r_labels, r_scores


@pytest.mark.parametrize("seed", [0, 1])
def test_render_panoptic_and_triplets_are_bit_equal(seed):
    image, masks, labels, pairs, r_labels, r_scores = _triplets(seed)
    pan = np.random.default_rng(seed + 10).integers(0, 5, size=image.shape[:2]) * 1000 + 3
    np.testing.assert_array_equal(pvis.render_panoptic(image, pan),
                                  jvis.render_panoptic(image, pan))
    for topk in (3, 10):
        args = (image, masks, labels, pairs, r_labels, r_scores, CLASSES, PREDICATES, topk)
        got, got_lines = pvis.render_triplets(*args)
        want, want_lines = jvis.render_triplets(*args)
        np.testing.assert_array_equal(got, want)
        assert got_lines == want_lines and len(got_lines) == min(topk, len(r_scores))


def test_render_scene_graph_matches_jax_but_the_glyphs():
    """The same DOT text and panel shape; every node's ring in its colour at
    the same place as PIL's; the edges (gray lines and arrowheads) within a
    pixel of PIL's. Only the text and its label boxes (sized from the
    glyphs) differ, and they cover parts of the edges differently."""
    _, _, labels, pairs, r_labels, r_scores = _triplets(0)
    args = (labels, pairs, r_labels, r_scores, CLASSES, PREDICATES, 5, (480, 480))
    got, got_dot = pvis.render_scene_graph(*args)
    want, want_dot = jvis.render_scene_graph(*args)
    assert got_dot == want_dot and got.shape == want.shape == (480, 480, 3)
    assert got.dtype == np.uint8
    nodes = []
    for k in np.argsort(-r_scores)[:5]:
        nodes += [int(i) for i in pairs[k] if int(i) not in nodes]
    cmap = pvis._colormap(len(nodes), seed=5)
    for i in range(len(nodes)):
        a = 2 * math.pi * i / len(nodes) - math.pi / 2
        x, y = 240 + 180 * math.cos(a), 240 + 180 * math.sin(a)  # centre, radius r = 180
        for dx, dy in ((19, 0), (-19, 0), (0, 19), (0, -19)):
            px, py = round(x + dx), round(y + dy)
            assert tuple(got[py, px]) == tuple(want[py, px]) == tuple(cmap[i]), (i, dx, dy)
    g_got, g_want = (got == GRAY).all(-1), (want == GRAY).all(-1)
    assert g_got.sum() > 100
    assert (g_got & binary_dilation(g_want)).sum() >= 0.9 * g_got.sum()
    assert (g_want & binary_dilation(g_got)).sum() >= 0.9 * g_want.sum()


def test_text_glyphs_are_drawn():
    canvas = np.full((12, 40, 3), 255, np.uint8)
    pvis.draw_text(canvas, (1, 2), "cat 7", (0, 0, 0))
    ink = (canvas == 0).all(-1)
    assert pvis.text_length("cat 7") == 30 and ink[2:9].any() and not ink[9:].any()
    assert not ink[:, 19:24].any()  # the space


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The ``--save-results`` pickle of the port's scoring CLI on the tiny
    synthetic split (seeded random weights, f32 on the CPU)."""
    path = str(tmp_path_factory.mktemp("results") / "results.pkl")
    test_cli.main([TINY, "--device", "cpu", "--dtype", "f32", "--save-results", path])
    return path


def _jax_vis(monkeypatch, results_pkl, out_dir, topk):
    """The JAX package's ``tools/vis_results.py``, run in this process."""
    spec = importlib.util.spec_from_file_location(
        "jax_vis_results", os.path.join(REPO, "tools", "vis_results.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [
        "vis_results.py", TINY, results_pkl, "--out-dir", out_dir, "--topk", str(topk),
        "--cfg-options", f"data.dataset.data_root={synthetic_root(TINY_SPLIT)}"])
    mod.main()


def _files(out_dir):
    return sorted(os.listdir(out_dir))


def test_vis_cli_matches_jax_and_needs_no_pil(results, tmp_path, monkeypatch):
    """Per image the same ``.triplets.txt`` and ``.dot`` as JAX's CLI, and
    the same first three panels (image, panoptic overlay, outlined
    triplets); then again with PIL blocked, the same files, and from the
    scoring CLI the same predictions."""
    topk = 8
    port_dir, jax_dir, nopil_dir = (str(tmp_path / d) for d in ("port", "jax", "nopil"))
    n = vis_results.main([TINY, results, "--out-dir", port_dir, "--topk", str(topk)])
    _jax_vis(monkeypatch, results, jax_dir, topk)
    assert n == TINY_SPLIT["num_test"]
    names = [f"{i:06d}.png" for i in range(n)]
    assert _files(port_dir) == _files(jax_dir) == sorted(
        f"{p}{ext}" for p in names for ext in ("", ".dot", ".triplets.txt"))
    for name in names:
        for ext in (".dot", ".triplets.txt"):
            with open(os.path.join(port_dir, name + ext)) as f, \
                    open(os.path.join(jax_dir, name + ext)) as g:
                assert f.read() == g.read(), name + ext
        got = png.read(os.path.join(port_dir, name))
        want = png.read(os.path.join(jax_dir, name))
        W3 = got.shape[1] - got.shape[0]  # 3W + H wide
        assert got.shape == want.shape and W3 % 3 == 0
        np.testing.assert_array_equal(got[:, :W3], want[:, :W3])

    for mod in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "PIL", None)  # any import of PIL raises
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    assert vis_results.main([TINY, results, "--out-dir", nopil_dir, "--topk", str(topk)]) == n
    nopil_pkl = str(tmp_path / "nopil.pkl")
    test_cli.main([TINY, "--device", "cpu", "--dtype", "f32", "--save-results", nopil_pkl])
    for p, q in zip(load_predictions(results), load_predictions(nopil_pkl)):
        for field in ("labels", "rel_pair_idxes", "rel_dists", "masks"):
            np.testing.assert_array_equal(getattr(p, field), getattr(q, field))
    assert _files(nopil_dir) == _files(port_dir)
    for name in _files(port_dir):
        with open(os.path.join(port_dir, name), "rb") as f, \
                open(os.path.join(nopil_dir, name), "rb") as g:
            assert f.read() == g.read(), name
