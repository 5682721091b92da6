"""Port parity: the data layer of ``pairnet_torch`` (PNG codec, synthetic PSG
fixture, PSG reader, test-time loader) against PIL and the JAX package."""

import collections
import io
import json
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from pairnet_tpu.config import load_config as j_load_config
from pairnet_tpu.data.pipeline import Loader as JLoader
from pairnet_tpu.data.synthetic import make_synthetic_psg as j_make_synthetic
from pairnet_tpu.train.builder import build_pipeline_cfg as j_build_pipeline_cfg

from test_torch_helpers import TINY_SPLIT, jax_dataset
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")

from pairnet_torch.config import load_config  # noqa: E402
from pairnet_torch.data import png  # noqa: E402
from pairnet_torch.data.pipeline import Loader  # noqa: E402
from pairnet_torch.data.psg import PSGDataset  # noqa: E402
from pairnet_torch.data.synthetic import make_synthetic_psg  # noqa: E402
from pairnet_torch.train.builder import (  # noqa: E402
    build_dataset,
    build_pipeline_cfg,
    synthetic_root,
)

TINY = "configs/pairnet/tiny_synthetic.py"


def _images(seed):
    """(mode, image) pairs: gray, RGB and RGBA images with ramps, noise, a
    checkerboard and vertical stripes, on which PIL's adaptive filtering picks the None, Sub, Up
    and Paeth row filters (it never picks Average)."""
    rng = np.random.default_rng(seed)
    h, w = 37, 53
    yy, xx = np.mgrid[:h, :w]
    ramp = (3 * xx + 5 * yy) % 256
    noise = rng.integers(0, 256, (h, w))
    smooth = np.where((yy // 6) % 2, ramp, (ramp + noise // 16) % 256)
    planes = [smooth, noise, (ramp * 7) % 256, 255 - smooth]
    return [("L", smooth.astype(np.uint8)), ("L", (((xx + yy) % 2) * 200).astype(np.uint8)),
            ("L", ((xx * 37 + seed) % 256).astype(np.uint8)),  # equal rows: Up
            ("RGB", np.stack(planes[:3], -1).astype(np.uint8)),
            ("RGBA", np.stack(planes, -1).astype(np.uint8))]


def _filtered_png(img, filters):
    """A PNG of ``img`` (H, W, C) uint8 whose row r uses the filter
    ``filters[r]`` (0-4), the filters written out as the PNG spec gives them."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int64)
    rows = []
    for r in range(h):
        up = x[r - 1] if r else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), x[r, :-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        pred = [0, left, up, (left + up) // 2, paeth][filters[r]]
        rows.append(bytes([filters[r]]) + ((x[r] - pred) % 256).astype(np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    chunk = lambda kind, data: (struct.pack(">I", len(data)) + kind + data  # noqa: E731
                                + struct.pack(">I", zlib.crc32(kind + data)))
    return (png.SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def _row_filters(buf):
    """The row filter bytes of a PNG (one IDAT stream)."""
    img = png.decode(buf)
    h = img.shape[0]
    idat = b""
    pos = 8
    while pos < len(buf):
        n = int.from_bytes(buf[pos : pos + 4], "big")
        if buf[pos + 4 : pos + 8] == b"IDAT":
            idat += buf[pos + 8 : pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, -1)[:, 0].tolist())


@pytest.mark.parametrize("seed", [0, 1])
def test_png_reads_pil_written_files_bit_exactly(seed):
    """PIL's encoder (adaptive row filters) -> the port's decoder."""
    filters = set()
    for mode, arr in _images(seed):
        buf = io.BytesIO()
        Image.fromarray(arr, mode=mode).save(buf, format="PNG")
        got = png.decode(buf.getvalue())
        np.testing.assert_array_equal(got, arr, err_msg=mode)
        filters |= _row_filters(buf.getvalue())
    assert filters == {0, 1, 2, 4}, filters


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_every_row_filter_matches_pil(channels):
    """Rows written with each of the five filters, Average included: the
    port's decoder and PIL's give the image back."""
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (23, 17, channels)).astype(np.uint8)
    img[5:12] = img[5:6]  # flat runs, so Up and Paeth see zero residuals too
    buf = _filtered_png(img, [r % 5 for r in range(img.shape[0])])
    assert _row_filters(buf) == {0, 1, 2, 3, 4}
    want = img[:, :, 0] if channels == 1 else img
    np.testing.assert_array_equal(png.decode(buf), want)
    with Image.open(io.BytesIO(buf)) as im:
        np.testing.assert_array_equal(np.asarray(im), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_pil_reads_port_written_files_bit_exactly(seed, tmp_path):
    for i, (mode, arr) in enumerate(_images(seed)):
        path = tmp_path / f"{i}.png"
        png.write(str(path), arr)
        with Image.open(path) as im:
            assert im.mode == mode
            np.testing.assert_array_equal(np.asarray(im), arr, err_msg=mode)
        np.testing.assert_array_equal(png.read(str(path)), arr)


def test_png_rejects_what_it_does_not_read(tmp_path):
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint8), mode="L").convert("P").save(buf, format="PNG")
    with pytest.raises(ValueError, match="colour type 3"):
        png.decode(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a")


def test_synthetic_fixture_and_annotations_equal_jax(tmp_path):
    """Same options and seed: the same psg.json, the same pixels (the JAX
    fixture read by PIL, the port's by its own decoder), and the same
    annotations from both readers."""
    opts = dict(num_images=5, num_test=2, height=40, width=56, seed=4)
    j_ann = j_make_synthetic(str(tmp_path / "jax"), **opts)
    t_ann = make_synthetic_psg(str(tmp_path / "port"), **opts)
    with open(j_ann) as f, open(t_ann) as g:
        assert json.load(f) == json.load(g)
    from pairnet_tpu.data.psg import PSGDataset as JPSGDataset

    for split in ("train", "test"):
        jd = JPSGDataset("psg.json", data_root=str(tmp_path / "jax"), split=split)
        td = PSGDataset("psg.json", data_root=str(tmp_path / "port"), split=split)
        assert len(jd) == len(td) > 0
        for i in range(len(td)):
            np.testing.assert_array_equal(td.load_image(i), jd.load_image(i))
            for a, b in zip(td.load_masks(i), jd.load_masks(i)):
                np.testing.assert_array_equal(a, b)
            ja, ta = jd.get_ann_info(i), td.get_ann_info(i)
            assert set(ja) == set(ta)
            for k in ja:
                if isinstance(ja[k], np.ndarray):
                    np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
                else:
                    assert ta[k] == ja[k], k
            jg, jm = jd.load_pan_ids(i)
            tg, tm = td.load_pan_ids(i)
            np.testing.assert_array_equal(tg, jg)
            assert tm == jm


@pytest.mark.parametrize("target_size", [None, (256, 512)])
def test_loader_batches_equal_jax(target_size):
    """tiny_synthetic, test split, batch 2 (the last batch padded): every
    array of every batch bit for bit."""
    overrides = {} if target_size is None else {"data.pipeline.target_size": target_size}
    jcfg, tcfg = j_load_config(TINY), load_config(TINY)
    for path, val in overrides.items():
        jcfg.set_path(path, val)
        tcfg.set_path(path, val)
    tds = build_dataset(tcfg, "test")
    jds = jax_dataset(synthetic_root(TINY_SPLIT), "test")
    jl = JLoader(jds, j_build_pipeline_cfg(jcfg, train=False), 2, train=False, seed=0)
    tl = Loader(tds, build_pipeline_cfg(tcfg, train=False), 2)
    n = 0
    for jb, tb in zip(jl, tl, strict=True):
        assert set(jb) == set(tb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        n += 1
    assert n == len(tl) == 2


def test_jax_loader_threads_find_the_native_library_loaded(monkeypatch):
    """The JAX package's native library loads lazily and not thread-safely:
    a loader thread that finds it marked tried but not yet loaded takes the
    PIL resize, a gray level off the native one, and its image parts from
    the port's (0.07 between the two packages' value planes in the CLI
    parity test). ``jax_dataset`` loads the library first; with the load
    slowed down so that the JAX loader's threads would overlap it, every
    batch still equals the port's bit for bit."""
    import ctypes
    import time

    from pairnet_tpu import native as j_native

    load = ctypes.CDLL

    def slow_load(*args, **kwargs):
        time.sleep(0.3)
        return load(*args, **kwargs)

    monkeypatch.setattr(j_native, "_TRIED", False)
    monkeypatch.setattr(j_native, "_LIB", None)
    monkeypatch.setattr(ctypes, "CDLL", slow_load)
    jcfg, tcfg = j_load_config(TINY), load_config(TINY)
    for cfg in (jcfg, tcfg):  # the CLI parity test's size: every image is resized
        cfg.set_path("data.pipeline.target_size", (256, 512))
    jds = jax_dataset(synthetic_root(TINY_SPLIT), "test")
    jl = JLoader(jds, j_build_pipeline_cfg(jcfg, train=False), 3, train=False, seed=0,
                 num_workers=3)
    tl = Loader(build_dataset(tcfg, "test"), build_pipeline_cfg(tcfg, train=False), 3)
    for jb, tb in zip(jl, tl, strict=True):
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


# train-time augmentation at the tiny fixture's size (96x128 images): the
# crop branch always taken, with crops small enough that some keep no
# triplet (the plain resize branch then runs), three train scales
TRAIN_AUG = {"data.pipeline.crop_prob": 1.0, "data.pipeline.crop_scales": (64, 96),
             "data.pipeline.crop_size_range": (24, 48),
             "data.pipeline.train_scales": (64, 80, 96)}


@pytest.mark.parametrize("num_workers", [0, 2], ids=["one_stream", "per_sample_rngs"])
@pytest.mark.parametrize("seed, flip_prob", [(0, 0.5), (5, 0.0)])
def test_train_loader_batches_equal_jax(seed, flip_prob, num_workers, monkeypatch):
    """The train split shuffled, cropped, rescaled and flipped: every array
    of every batch of two epochs (loader seeds ``seed`` and ``seed + 1``,
    as the train CLI gives them) bit for bit, with the caller's thread
    drawing from one stream and with two threads drawing per-sample rngs.
    At ``flip_prob=0`` the flip's coin is still drawn. The split has no
    (subject, object) pair with two predicates, so the dataset's own draws
    do not depend on the threads' order."""
    from pairnet_torch.data import pipeline

    crops = collections.Counter()
    crop = pipeline.rel_random_crop

    def counting_crop(*args):
        out = crop(*args)
        crops["kept" if out is not None else "no triplet"] += 1
        return out

    monkeypatch.setattr(pipeline, "rel_random_crop", counting_crop)
    jcfg, tcfg = j_load_config(TINY), load_config(TINY)
    for path, val in {**TRAIN_AUG, "data.pipeline.flip_prob": flip_prob}.items():
        jcfg.set_path(path, val)
        tcfg.set_path(path, val)
    tds = build_dataset(tcfg, "train")
    jds = jax_dataset(synthetic_root(TINY_SPLIT), "train")
    for d in tds.data:
        pairs = [(int(s), int(o)) for s, o, _ in d.relations]
        assert len(pairs) == len(set(pairs))
    n = 0
    for epoch in range(2):
        jl = JLoader(jds, j_build_pipeline_cfg(jcfg, train=True), 2, train=True,
                     seed=seed + epoch, num_workers=num_workers)
        tl = Loader(tds, build_pipeline_cfg(tcfg, train=True), 2, train=True, seed=seed + epoch,
                    num_workers=num_workers)
        assert len(tl) == len(jl) == len(tds) // 2
        for jb, tb in zip(jl, tl, strict=True):
            assert set(jb) == set(tb)
            for k in jb:
                assert tb[k].dtype == jb[k].dtype, k
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=f"epoch {epoch} {k}")
            n += 1
    assert n == 4
    assert crops["kept"] > 0 and crops["no triplet"] > 0, crops


def test_loader_reads_its_worker_count_from_the_environment(monkeypatch):
    monkeypatch.setenv("PAIRNET_LOADER_WORKERS", "3")
    cfg = build_pipeline_cfg(load_config(TINY), train=True)
    assert Loader([], cfg, 2).num_workers == 3
    assert Loader([], cfg, 2, num_workers=0).num_workers == 0
    assert Loader([], cfg, 2, train=True).drop_last and not Loader([], cfg, 2).drop_last


@pytest.mark.parametrize("seed", range(6))
def test_rel_random_crop_equals_jax(seed):
    """A hand-made 8x8 image with four instances in column pairs (0: 0-1,
    2: 2-3, 3: 4-5, 1: 6-7) and a 8x4 crop at a drawn x offset: the kept
    instances and the relations re-indexed by the prefix sum of kept ones,
    as JAX's, and as worked out here; None when no triplet survives."""
    from pairnet_tpu.data.pipeline import rel_random_crop as j_crop

    from pairnet_torch.data.pipeline import rel_random_crop

    img = np.arange(8 * 8 * 3, dtype=np.uint8).reshape(8, 8, 3)
    cols = {0: (0, 2), 2: (2, 4), 3: (4, 6), 1: (6, 8)}
    masks = np.zeros((4, 8, 8), bool)
    for i, (a, b) in cols.items():
        masks[i, :, a:b] = True
    labels = np.asarray([10, 11, 12, 13])
    rels = np.asarray([[0, 2, 1], [1, 3, 2], [2, 3, 3], [0, 1, 4]], np.int32)
    got = rel_random_crop(img, masks, labels, rels, (8, 4), np.random.default_rng(seed))
    want = j_crop(img, masks, labels, rels, (8, 4), np.random.default_rng(seed))
    probe = np.random.default_rng(seed)
    probe.integers(0, 1)  # off_y: the crop spans the height
    off_x = int(probe.integers(0, 5))
    kept = [i for i, (a, b) in sorted(cols.items()) if a < off_x + 4 and b > off_x]
    new = {i: k for k, i in enumerate(kept)}
    rels_left = [[new[s], new[o], p] for s, o, p in rels.tolist() if s in new and o in new]
    if not rels_left:
        assert got is None and want is None
        return
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], img[:, off_x:off_x + 4])
    np.testing.assert_array_equal(got[2], labels[kept])
    assert got[3].tolist() == rels_left


@pytest.mark.parametrize("thr", [0.03, 0.3])
def test_balanced_sampler_equals_jax(thr):
    """``repeat_indices`` and every wrapped sample's annotations, image and
    masks, as the JAX package's ``BalancedRelationDataset`` gives them on
    the same split; 0.3 repeats some images."""
    from pairnet_tpu.data.sg import BalancedRelationDataset as JBalanced

    from pairnet_torch.data.psg import PSGDataset
    from pairnet_torch.data.sg import BalancedRelationDataset

    root = synthetic_root(TINY_SPLIT)
    jb = JBalanced(jax_dataset(root, "train"), oversample_thr=thr)
    tb = BalancedRelationDataset(PSGDataset("psg.json", data_root=root, split="train"),
                                 oversample_thr=thr)
    assert tb.repeat_indices == jb.repeat_indices
    assert len(tb) == len(jb) == len(tb.data)
    if thr == 0.3:
        assert len(tb) > len(tb.dataset)
    for i in range(len(tb)):
        assert tb.data[i].image_id == jb.data[i].image_id
        ja, ta = jb.get_ann_info(i), tb.get_ann_info(i)
        for k in ("bboxes", "labels", "rels", "rel_maps"):
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
        np.testing.assert_array_equal(tb.load_image(i), jb.load_image(i))
        for a, b in zip(tb.load_masks(i), jb.load_masks(i)):
            np.testing.assert_array_equal(a, b)


def test_build_dataset_balances_only_the_train_split():
    from pairnet_torch.data.sg import BalancedRelationDataset

    cfg = load_config(TINY)
    cfg.set_path("data.dataset.balanced", {"oversample_thr": 0.3})
    train, test = build_dataset(cfg, "train"), build_dataset(cfg, "test")
    assert isinstance(train, BalancedRelationDataset) and train.dataset.split == "train"
    assert isinstance(test, PSGDataset) and test.split == "test"
