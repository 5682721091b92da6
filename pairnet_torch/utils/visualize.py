"""Prediction visualization: panoptic overlays, scene-graph triplet lists and
a drawn scene graph, with numpy only (no PIL).

Counterpart of ``pairnet_tpu/utils/visualize.py``. ``render_panoptic`` and
``render_triplets`` compute the same arrays and lines, bit for bit.
``render_scene_graph`` gives the same layout, node positions, edge
geometry and DOT text, drawn by this module's own rasteriser (lines,
filled triangles, ellipse outlines, filled rectangles); its text uses a
fixed-width 5x7 bitmap font kept here as a table, so only the glyphs (and
the label boxes sized from them) differ from PIL's default font.
``save_visualization`` writes the PNG with ``pairnet_torch.data.png``.
"""

from __future__ import annotations

import math

import numpy as np

from pairnet_torch.data import png

# 5x7 glyphs of ASCII 32..126, five column bytes each (bit 0 = top row)
_FONT_HEX = (
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12" "2313086462"
    "3649552250" "0005030000" "001c224100" "0041221c00" "082a1c2a08" "08083e0808"
    "0050300000" "0808080808" "0060600000" "2010080402" "3e5149453e" "00427f4000"
    "4261514946" "2141454b31" "1814127f10" "2745454539" "3c4a494930" "0171090503"
    "3649494936" "064949291e" "0036360000" "0056360000" "0008142241" "1414141414"
    "4122140800" "0201510906" "324979413e" "7e1111117e" "7f49494936" "3e41414122"
    "7f4141221c" "7f49494941" "7f09090101" "3e41415132" "7f0808087f" "00417f4100"
    "2040413f01" "7f08142241" "7f40404040" "7f0204027f" "7f0408107f" "3e4141413e"
    "7f09090906" "3e4151215e" "7f09192946" "4649494931" "01017f0101" "3f4040403f"
    "1f2040201f" "7f2018207f" "6314081463" "0304780403" "6151494543" "00007f4141"
    "0204081020" "41417f0000" "0402010204" "4040404040" "0001020400" "2054545478"
    "7f48444438" "3844444420" "384444487f" "3854545418" "087e090102" "081454543c"
    "7f08040478" "00447d4000" "2040443d00" "007f102844" "00417f4000" "7c04180478"
    "7c08040478" "3844444438" "7c14141408" "081414187c" "7c08040408" "4854545420"
    "043f444020" "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "0c5050503c"
    "4464544c44" "0008364100" "00007f0000" "0041360800" "08082a1c08"
)
GLYPH_H, ADVANCE = 7, 6  # pixels; ADVANCE = the 5-pixel glyph + 1 blank column


def _glyph(ch: str) -> np.ndarray:
    """(7, 5) bool bitmap of ``ch``; characters outside ASCII 32..126 draw as '?'."""
    code = ord(ch) if 32 <= ord(ch) <= 126 else ord("?")
    cols = bytes.fromhex(_FONT_HEX[(code - 32) * 10:(code - 31) * 10])
    return np.array([[(c >> row) & 1 for c in cols] for row in range(GLYPH_H)], bool)


def text_length(text: str) -> int:
    """Width in pixels of ``text`` in the bitmap font."""
    return ADVANCE * len(text)


def _colormap(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(40, 255, size=(n, 3)).astype(np.uint8)


# --- the rasteriser: pixel (x, y) has its centre at integer (x, y) ---

def _grid(canvas, x0, y0, x1, y1):
    """Integer pixel coordinates of the canvas inside [x0, x1] x [y0, y1]:
    (ys, xs) index ranges and the coordinate grids, or None if empty."""
    H, W = canvas.shape[:2]
    xa, xb = max(int(math.floor(x0)), 0), min(int(math.ceil(x1)), W - 1)
    ya, yb = max(int(math.floor(y0)), 0), min(int(math.ceil(y1)), H - 1)
    if xa > xb or ya > yb:
        return None
    ys, xs = np.mgrid[ya:yb + 1, xa:xb + 1]
    return (slice(ya, yb + 1), slice(xa, xb + 1)), xs.astype(np.float64), ys.astype(np.float64)


def draw_line(canvas, p0, p1, color, width=1):
    """Pixels within ``width / 2`` of the segment p0-p1."""
    (x0, y0), (x1, y1) = p0, p1
    r = width / 2
    g = _grid(canvas, min(x0, x1) - r, min(y0, y1) - r, max(x0, x1) + r, max(y0, y1) + r)
    if g is None:
        return
    sl, xs, ys = g
    dx, dy = x1 - x0, y1 - y0
    t = np.clip(((xs - x0) * dx + (ys - y0) * dy) / max(dx * dx + dy * dy, 1e-12), 0.0, 1.0)
    dist2 = (xs - x0 - t * dx) ** 2 + (ys - y0 - t * dy) ** 2
    canvas[sl][dist2 <= r * r] = color


def draw_polygon(canvas, pts, color):
    """Fill the convex polygon ``pts`` (pixel centres inside or on an edge)."""
    xs_p, ys_p = [p[0] for p in pts], [p[1] for p in pts]
    g = _grid(canvas, min(xs_p), min(ys_p), max(xs_p), max(ys_p))
    if g is None:
        return
    sl, xs, ys = g
    n = len(pts)
    sides = [(pts[(i + 1) % n][0] - pts[i][0]) * (ys - pts[i][1])
             - (pts[(i + 1) % n][1] - pts[i][1]) * (xs - pts[i][0]) for i in range(n)]
    eps = 1e-9
    inside = np.all([s >= -eps for s in sides], axis=0) | np.all([s <= eps for s in sides],
                                                                 axis=0)
    canvas[sl][inside] = color


def draw_ellipse_outline(canvas, box, color, width=1):
    """The ring of ``width`` pixels inside the ellipse inscribed in ``box``
    ([x0, y0, x1, y1], inclusive)."""
    x0, y0, x1, y1 = box
    g = _grid(canvas, x0, y0, x1, y1)
    if g is None:
        return
    sl, xs, ys = g
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    a, b = (x1 - x0) / 2 + 0.5, (y1 - y0) / 2 + 0.5  # out to the edge pixels' outer side
    outer = ((xs - cx) / a) ** 2 + ((ys - cy) / b) ** 2 <= 1.0
    ai, bi = max(a - width, 1e-6), max(b - width, 1e-6)
    inner = ((xs - cx) / ai) ** 2 + ((ys - cy) / bi) ** 2 < 1.0
    canvas[sl][outer & ~inner] = color


def draw_rectangle(canvas, box, color):
    """Fill [x0, y0, x1, y1] (inclusive, rounded to pixels)."""
    x0, y0, x1, y1 = (int(round(v)) for v in box)
    H, W = canvas.shape[:2]
    canvas[max(y0, 0):min(y1, H - 1) + 1, max(x0, 0):min(x1, W - 1) + 1] = color


def draw_text(canvas, xy, text, color):
    """``text`` in the bitmap font with its top-left corner at ``xy``."""
    x, y = int(round(xy[0])), int(round(xy[1]))
    H, W = canvas.shape[:2]
    for i, ch in enumerate(text):
        gx = x + i * ADVANCE
        rows, cols = np.nonzero(_glyph(ch))
        px, py = gx + cols, y + rows
        keep = (px >= 0) & (px < W) & (py >= 0) & (py < H)
        canvas[py[keep], px[keep]] = color


# --- the panels ---

def render_panoptic(
    image: np.ndarray,  # (H, W, 3) uint8
    pan_seg: np.ndarray,  # (H, W) int
    alpha: float = 0.5,
) -> np.ndarray:
    ids = np.unique(pan_seg)
    cmap = _colormap(len(ids))
    overlay = np.zeros_like(image)
    for i, sid in enumerate(ids):
        overlay[pan_seg == sid] = cmap[i]
    return (image.astype(np.float32) * (1 - alpha) + overlay * alpha).astype(np.uint8)


def render_triplets(
    image: np.ndarray,
    masks: np.ndarray,  # (2K, H, W) bool, subjects then objects
    labels: np.ndarray,  # (2K,) 1-based
    rel_pairs: np.ndarray,  # (K, 2)
    r_labels: np.ndarray,  # (K,) 1-based predicates
    r_scores: np.ndarray,  # (K,)
    class_names: list[str],
    predicate_names: list[str],
    topk: int = 10,
) -> tuple[np.ndarray, list[str]]:
    """(image with each top-k triplet's subject and object outlined, the
    'subject --predicate--> object (score)' lines)."""
    cmap = _colormap(topk, seed=3)
    lines = []
    order = np.argsort(-np.asarray(r_scores))[:topk]
    arr = np.asarray(image, np.uint8).copy()
    for rank, k in enumerate(order):
        s_i, o_i = (int(x) for x in rel_pairs[k])
        s_name = class_names[int(labels[s_i]) - 1]
        o_name = class_names[int(labels[o_i]) - 1]
        p_name = predicate_names[int(r_labels[k]) - 1]
        lines.append(f"{s_name} --{p_name}--> {o_name} ({float(r_scores[k]):.3f})")
        color = cmap[rank]
        for idx in (s_i, o_i):
            m = np.asarray(masks[idx], bool)
            if m.shape != arr.shape[:2] or not m.any():
                continue
            edge = m ^ np.roll(m, 1, 0) | (m ^ np.roll(m, 1, 1))
            arr[edge] = color
    return arr, lines


def render_scene_graph(
    labels: np.ndarray,  # (2K,) 1-based entity labels
    rel_pairs: np.ndarray,  # (K, 2)
    r_labels: np.ndarray,  # (K,) 1-based predicates
    r_scores: np.ndarray,  # (K,)
    class_names: list[str],
    predicate_names: list[str],
    topk: int = 10,
    size: tuple[int, int] = (480, 480),
) -> tuple[np.ndarray, str]:
    """(panel (H, W, 3) uint8, graphviz DOT text) of the top-k triplets: the
    unique entities on a circle in first-appearance order, an arrow with its
    predicate for each triplet."""
    order = np.argsort(-np.asarray(r_scores))[:topk]
    node_ids: list[int] = []
    edges = []
    for k in order:
        s_i, o_i = (int(x) for x in rel_pairs[k])
        for idx in (s_i, o_i):
            if idx not in node_ids:
                node_ids.append(idx)
        edges.append((s_i, o_i, int(r_labels[k]), float(r_scores[k])))

    W, H = size
    img = np.full((H, W, 3), 255, np.uint8)
    n = max(len(node_ids), 1)
    cx, cy, r = W / 2, H / 2, min(W, H) / 2 - 60
    pos = {}
    for i, idx in enumerate(node_ids):
        a = 2 * math.pi * i / n - math.pi / 2
        pos[idx] = (cx + r * math.cos(a), cy + r * math.sin(a))

    cmap = _colormap(max(n, 1), seed=5)
    gray = (90, 90, 90)
    dot = ["digraph scene_graph {"]
    for s_i, o_i, p, score in edges:
        x1, y1 = pos[s_i]
        x2, y2 = pos[o_i]
        # shorten so that the arrows stop at the node circles
        dx, dy = x2 - x1, y2 - y1
        d = max((dx * dx + dy * dy) ** 0.5, 1e-6)
        ux, uy = dx / d, dy / d
        sx, sy = x1 + ux * 22, y1 + uy * 22
        ex, ey = x2 - ux * 22, y2 - uy * 22
        draw_line(img, (sx, sy), (ex, ey), gray, width=2)
        left = (ex - ux * 10 - uy * 5, ey - uy * 10 + ux * 5)
        right = (ex - ux * 10 + uy * 5, ey - uy * 10 - ux * 5)
        draw_polygon(img, [(ex, ey), left, right], gray)
        p_name = predicate_names[p - 1]
        mx, my = (sx + ex) / 2, (sy + ey) / 2
        tw = text_length(p_name)
        draw_rectangle(img, [mx - tw / 2 - 2, my - 7, mx + tw / 2 + 2, my + 7], (255, 255, 255))
        draw_text(img, (mx - tw / 2, my - 6), p_name, (180, 40, 40))
        dot.append(f'  n{s_i} -> n{o_i} [label="{p_name}" weight={score:.3f}];')
    for i, idx in enumerate(node_ids):
        x, y = pos[idx]
        name = class_names[int(labels[idx]) - 1]
        draw_ellipse_outline(img, [x - 20, y - 20, x + 20, y + 20], cmap[i], width=3)
        tw = text_length(name)
        draw_rectangle(img, [x - tw / 2 - 2, y + 22, x + tw / 2 + 2, y + 36], (255, 255, 255))
        draw_text(img, (x - tw / 2, y + 23), name, (0, 0, 0))
        dot.append(f'  n{idx} [label="{name}"];')
    dot.append("}")
    return img, "\n".join(dot)


def save_visualization(path: str, image, pan_seg=None, **triplet_kwargs):
    """Write ``path`` (PNG): the image, its panoptic overlay (if
    ``pan_seg``), and with ``triplet_kwargs`` (those of
    :func:`render_triplets`) the outlined triplets and the scene graph,
    side by side, plus ``path.dot`` and ``path.triplets.txt``. Returns the
    triplet lines."""
    panels = [np.asarray(image, np.uint8)]
    if pan_seg is not None:
        panels.append(render_panoptic(panels[0], np.asarray(pan_seg)))
    lines: list[str] = []
    if triplet_kwargs:
        rendered, lines = render_triplets(panels[0], **triplet_kwargs)
        panels.append(rendered)
        side = panels[0].shape[0]  # the graph is square, as tall as the image
        graph, dot = render_scene_graph(
            triplet_kwargs["labels"], triplet_kwargs["rel_pairs"], triplet_kwargs["r_labels"],
            triplet_kwargs["r_scores"], triplet_kwargs["class_names"],
            triplet_kwargs["predicate_names"], topk=triplet_kwargs.get("topk", 10),
            size=(side, side),
        )
        panels.append(graph)
        with open(path + ".dot", "w") as f:
            f.write(dot)
    png.write(path, np.concatenate(panels, axis=1))
    if lines:
        with open(path + ".triplets.txt", "w") as f:
            f.write("\n".join(lines))
    return lines
