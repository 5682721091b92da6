"""Rules of the PyTorch port: no JAX inside it (and no PIL at module level),
CUDA by default and no fallback from a CUDA tensor, kernel launch counters,
build rules and build errors."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_helpers import msda_inputs
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch import flagship as flagship_mod  # noqa: E402
from pairnet_torch.ops import _build  # noqa: E402
from pairnet_torch.ops.deform_attn import ms_deform_attn  # noqa: E402
from pairnet_torch.ops.deform_attn_exact import deform_attn_exact  # noqa: E402
from pairnet_torch.ops import deform_attn_int4, hungarian, masked_attn, nms  # noqa: E402
from pairnet_torch.ops.deform_attn_int4 import int4_gather, int4_quantize  # noqa: E402
from pairnet_torch.ops.deform_attn_int8 import int8_gather, int8_quantize  # noqa: E402
from pairnet_torch.ops.hungarian import batched_hungarian  # noqa: E402
from pairnet_torch.ops.masked_attn import masked_flash_attention  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "pairnet_tpu"}


def _port_files():
    return sorted((ROOT / "pairnet_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_pil_at_module_level(path):
    """The card has no PIL: the port imports it only inside the functions
    that need it (non-PNG images, the numpy oracle's mask resize)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        assert not any(n.split(".")[0] == "PIL" for n in names), f"{path}:{node.lineno}"


NO_PIL = ("pairnet_torch/utils/visualize.py", "pairnet_torch/tools/vis_results.py",
          "pairnet_torch/evaluation/runner.py")


@pytest.mark.parametrize("rel", NO_PIL)
def test_vis_and_scoring_import_no_pil_anywhere(rel):
    """The vis CLI and the scoring oracle draw, write and resize without
    PIL, inside functions too."""
    path = ROOT / rel
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        assert not any(n.split(".")[0] == "PIL" for n in names), f"{rel}:{node.lineno}"


def test_import_leaves_jax_out():
    code = (
        "import sys, pairnet_torch.flagship, pairnet_torch.bench, pairnet_torch.tools.test, "
        "pairnet_torch.evaluation.runner, pairnet_torch.train.builder, "
        "pairnet_torch.tools.train, pairnet_torch.data.sg, pairnet_torch.tools.vis_results, "
        "pairnet_torch.utils.visualize, pairnet_torch.models.backbones.swin, "
        "pairnet_torch.models.heads.psgtr_head, pairnet_torch.models.heads.psgformer_head, "
        "pairnet_torch.models.heads.baseline_head, pairnet_torch.models.heads.psgtr2_head, "
        "pairnet_torch.models.heads.detr4seg_head, pairnet_torch.models.heads.diagnostic, "
        "pairnet_torch.ops.boxes, pairnet_torch.train.dispatch, "
        "pairnet_torch.models.heads.pairnet_bbox_head, pairnet_torch.models.backbones.resnet; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'orbax', 'pairnet_tpu', 'PIL')); assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


# the port's test files (test_torch_convert.py predates the port; the
# helpers and the rank functions of test_torch_dist.py hold no tests)
PORT_TEST_FILES = sorted(p for p in (ROOT / "tests").glob("test_torch_*.py")
                         if p.name not in ("test_torch_convert.py", "test_torch_helpers.py",
                                           "test_torch_dist.py"))


@pytest.mark.parametrize("path", PORT_TEST_FILES, ids=lambda p: p.name)
def test_port_test_file_keeps_torch_rng(path):
    """Every port test file imports ``keep_torch_rng``, the module-scoped
    autouse fixture that restores torch's global RNG after the file: a JAX
    test later in the same xdist worker that draws torch weights from the
    global RNG draws the weights of a run alone."""
    tree = ast.parse(path.read_text(), filename=str(path))
    assert any(isinstance(n, ast.ImportFrom) and n.module == "test_torch_helpers"
               and any(a.name == "keep_torch_rng" for a in n.names) for n in tree.body), path.name


def test_port_test_files_draw_nothing_at_import():
    """Importing every port test module (and its helpers) leaves torch's
    global RNG as it was: no seed and no draw at module level."""
    names = [p.stem for p in PORT_TEST_FILES] + ["test_torch_helpers", "test_torch_dist"]
    code = (
        "import importlib, sys, torch\n"
        "sys.path.insert(0, 'tests')\n"
        "torch.manual_seed(1234)\n"
        "bad = []\n"
        f"for name in {names!r}:\n"
        "    before = torch.random.get_rng_state()\n"
        "    importlib.import_module(name)\n"
        "    if not torch.equal(before, torch.random.get_rng_state()):\n"
        "        bad.append(name)\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"})


def test_flagship_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flagship_mod.flagship(tiny=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flagship_mod.resolve_device("cuda")
    assert flagship_mod.resolve_device("cpu").type == "cpu"


def test_swin_flagship_and_build_model_default_to_cuda(monkeypatch):
    from pairnet_torch.config import load_config
    from pairnet_torch.models.frameworks.psgtr import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(str(ROOT / "configs" / "pairnet" / "pairnet_direct_r50_psg.py"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flagship_mod.flagship(tiny=True, backbone="swinb")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg.model)
    assert flagship_mod.flagship(tiny=True, backbone="swinb", device="cpu").training is False
    with pytest.raises(ValueError, match="backbone"):
        flagship_mod.flagship(tiny=True, backbone="r101", device="cpu")


def _launches():
    return [deform_attn_exact.launches, int4_quantize.launches, int4_gather.launches,
            dict(int8_quantize.launches), dict(int8_gather.launches),
            masked_flash_attention.launches, batched_hungarian.launches, nms.nms_sorted.launches]


def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    before = _launches()
    shapes, value, locs, w = msda_inputs(seed=7, B=1, H=2, D=8, Q=30)
    v, lc, wt = torch.tensor(value), torch.tensor(locs), torch.tensor(w)
    out = deform_attn_exact(v, shapes, lc, wt)
    codes, scales = int4_quantize(v, shapes)
    out4 = int4_gather(codes, scales, shapes, lc, wt)
    codes8, scales8 = int8_quantize(v, shapes)
    out8 = int8_gather(codes8, scales8, shapes, lc, wt)
    for impl in (None, "exact", "int4", "int8"):
        ms_deform_attn(v, shapes, lc, wt, impl=impl)
    q = torch.randn(4, 5, 8)
    flash = masked_flash_attention(q, torch.randn(4, 9, 8), torch.randn(4, 9, 8),
                                   torch.rand(2, 5, 9) < 0.5, 2)
    keep = nms.nms(torch.rand(2, 6, 4).cumsum(-1), torch.rand(2, 6), 0.5)
    syncs = batched_hungarian.syncs
    row2col, _ = batched_hungarian(torch.randn(2, 5, 7))
    assert batched_hungarian.syncs > syncs  # the plain loop reads its flag on the host
    assert _launches() == before
    assert row2col.dtype == torch.int64 and (row2col >= 0).all()
    assert keep.dtype == torch.bool and keep.any()
    assert out.dtype == torch.float32 and out4.dtype == out8.dtype == torch.bfloat16
    assert flash.dtype == torch.float32 and np.isfinite(flash.numpy()).all()
    assert np.isfinite(out.numpy()).all()


def test_new_wrappers_take_no_plain_version_off_the_cpu():
    """A tensor on another device than the CPU reaches a kernel or raises;
    it never takes the plain version (meta tensors stand in for a device)."""
    shapes = ((2, 3),)
    v = torch.empty((1, 6, 2, 8), device="meta")
    lc = torch.empty((1, 4, 2, 1, 2, 2), device="meta")
    wt = torch.empty((1, 4, 2, 1, 2), device="meta")
    codes = torch.empty((1, 6, 2, 8), dtype=torch.int8, device="meta")
    scales = torch.empty((1, 2, 1, 8), device="meta")
    q = torch.empty((2, 5, 8), device="meta")
    kv = torch.empty((2, 9, 8), device="meta")
    mask = torch.empty((1, 5, 9), dtype=torch.bool, device="meta")
    cost = torch.empty((2, 5, 7), device="meta")
    before = _launches()
    for call in (lambda: int8_quantize(v, shapes),
                 lambda: int8_gather(codes, scales, shapes, lc, wt),
                 lambda: masked_flash_attention(q, kv, kv, mask, 2),
                 lambda: batched_hungarian(cost), lambda: batched_hungarian(cost.mT),
                 lambda: nms.nms_sorted(torch.empty((2, 5, 4), device="meta"),
                                        torch.empty((2, 5), dtype=torch.bool, device="meta"),
                                        0.5)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    assert _launches() == before


def test_cuda_tensor_without_a_card_raises(monkeypatch):
    """No card: the wrappers of the new kernels raise for a tensor that
    claims the CUDA device (they allocate on it, which a CPU build refuses)."""
    class CudaMeta(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    def fake(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype).as_subclass(CudaMeta)

    shapes = ((2, 3),)
    for call in (lambda: int8_quantize(fake((1, 6, 2, 8)), shapes),
                 lambda: int8_gather(fake((1, 6, 2, 8), torch.int8), fake((1, 2, 1, 8)), shapes,
                                     fake((1, 4, 2, 1, 2, 2)), fake((1, 4, 2, 1, 2))),
                 lambda: masked_flash_attention(fake((2, 5, 8)), fake((2, 9, 8)),
                                                fake((2, 9, 8)), fake((1, 5, 9), torch.bool), 2),
                 lambda: batched_hungarian(fake((2, 5, 7))),
                 lambda: nms.nms_sorted(fake((2, 5, 4)), fake((2, 5), torch.bool), 0.5)):
        with pytest.raises((RuntimeError, AssertionError)):
            call()


def test_quantize_workspace_is_zeroed_once_per_stream(monkeypatch):
    """The quantize's workspace is allocated zeroed once per (device,
    stream) and reused while it is large enough, so a call launches no
    fill; a call that needs more gets a larger zeroed one."""
    monkeypatch.setattr(deform_attn_int4, "_workspaces", {})
    cpu = torch.device("cpu")
    ws = deform_attn_int4.quantize_workspace(cpu, 7, 100)
    assert ws.dtype == torch.int32 and ws.numel() == 100 and not ws.any()
    assert deform_attn_int4.quantize_workspace(cpu, 7, 60) is ws
    other = deform_attn_int4.quantize_workspace(cpu, 8, 60)
    assert other is not ws and other.numel() == 60
    grown = deform_attn_int4.quantize_workspace(cpu, 7, 101)
    assert grown is not ws and grown.numel() == 101 and not grown.any()
    assert deform_attn_int4.quantize_workspace(cpu, 7, 100) is grown


@pytest.mark.parametrize("lib", [deform_attn_int4._lib, masked_attn._lib, hungarian._lib,
                                 nms._lib],
                         ids=["deform_attn_quant", "masked_attn", "hungarian", "nms"])
def test_failed_build_raises_from_the_new_wrappers(monkeypatch, lib):
    def fail(name):
        raise _build.BuildError(f"CUDA build failed: {name}.cu")

    monkeypatch.setattr(_build, "load", fail)
    lib.cache_clear()
    with pytest.raises(_build.BuildError, match="CUDA build failed"):
        lib()
    lib.cache_clear()


def test_every_source_is_built_and_binds_its_entry_points():
    """``_build.SOURCES`` is every ``csrc/*.cu``, and each C entry point a
    wrapper binds is defined in its source."""
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC.glob("*.cu")}
    entries = {
        "deform_attn_quant": deform_attn_int4.QUANTIZE_FNS + deform_attn_int4.GATHER_FNS,
        "masked_attn": tuple(masked_attn._FN.values()),
        "hungarian": ("hungarian_solve", "hungarian_solve_long"),
        "nms": ("nms_sorted", "nms_max_boxes"),
    }
    for source, names in entries.items():
        text = (_build.CSRC / f"{source}.cu").read_text()
        for name in names:
            assert f"ENTRY({name}," in text or f'extern "C" int {name}(' in text, (source, name)


@pytest.mark.parametrize("fail", [False, True])
def test_build_runs_one_nvcc_per_source(monkeypatch, tmp_path, fail):
    """``build()`` starts one nvcc per source, all at once, and raises
    naming the source when one fails."""
    log = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    f"echo \"$@\" >> {log}\n"
                    f"case \"$*\" in *masked_attn.cu*) [ {int(fail)} = 1 ] && exit 3;; esac\n"
                    "while [ \"$1\" != -o ]; do shift; done; touch \"$2\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if fail:
        with pytest.raises(_build.BuildError, match="masked_attn.cu"):
            _build.build()
    else:
        targets = _build.build()
        assert set(targets) == set(_build.SOURCES) and all(t.exists() for t in targets.values())
    calls = log.read_text().splitlines()
    assert sorted(c.split()[-1].rsplit("/", 1)[1] for c in calls) == sorted(
        f"{n}.cu" for n in _build.SOURCES)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.build()


def test_launcher_error_raises():
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        _build.check(9, "int4_gather")
