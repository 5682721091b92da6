"""Rules of the PyTorch port: no JAX inside it, CUDA by default and no
fallback from a CUDA tensor, kernel launch counters, build errors."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_helpers import msda_inputs

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch import flagship as flagship_mod  # noqa: E402
from pairnet_torch.ops import _build  # noqa: E402
from pairnet_torch.ops.deform_attn import ms_deform_attn  # noqa: E402
from pairnet_torch.ops.deform_attn_exact import deform_attn_exact  # noqa: E402
from pairnet_torch.ops.deform_attn_int4 import int4_gather, int4_quantize  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pairnet_tpu"}


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


def test_import_leaves_jax_out():
    code = (
        "import sys, pairnet_torch.flagship, pairnet_torch.bench; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'pairnet_tpu')); assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def test_flagship_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flagship_mod.flagship(tiny=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flagship_mod.resolve_device("cuda")
    assert flagship_mod.resolve_device("cpu").type == "cpu"


def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    wrappers = (deform_attn_exact, int4_quantize, int4_gather)
    before = [w.launches for w in wrappers]
    shapes, value, locs, w = msda_inputs(seed=7, B=1, H=2, D=8, Q=30)
    v, lc, wt = torch.tensor(value), torch.tensor(locs), torch.tensor(w)
    out = deform_attn_exact(v, shapes, lc, wt)
    codes, scales = int4_quantize(v, shapes)
    out4 = int4_gather(codes, scales, shapes, lc, wt)
    for impl in (None, "exact", "int4"):
        ms_deform_attn(v, shapes, lc, wt, impl=impl)
    assert [w.launches for w in wrappers] == before
    assert out.dtype == torch.float32 and out4.dtype == torch.bfloat16
    assert np.isfinite(out.numpy()).all()


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
