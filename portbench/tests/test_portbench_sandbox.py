"""A run on the CPU in a child process, at tiny sizes: it loads nothing of
the JAX stack or the JAX package, the reference loads nothing of the port,
the guard names what it finds, and every file the run writes lies inside
the checkout, HOME, XDG_CACHE_HOME or TMPDIR."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import forbidden_modules
from portbench.registry import ROOT

CHILD = r"""
import json, os, sys, time
written = set()
def audit(event, args):
    if event == "open" and args[0] is not None and isinstance(args[0], (str, bytes)):
        mode, flags = args[1] or "", args[2] or 0
        if any(c in mode for c in "wax+") or flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT):
            written.add(os.fsdecode(args[0]))
    elif event in ("os.mkdir", "os.rename", "os.replace", "os.remove", "os.rmdir",
                   "shutil.copyfile", "shutil.rmtree"):
        written.add(os.fsdecode(args[0]))
sys.addaudithook(audit)
import torch
torch.set_num_threads(2)
from portbench.registry import Bench
from portbench.run import run_cell
from portbench.harness import forbidden_modules
result, _ = run_cell(Bench(sys.argv[1]), sys.argv[2], 5, 0.2, sys.argv[3] == "1", "cpu",
                     t0=time.perf_counter())
print(json.dumps({"forbidden": forbidden_modules(), "correct": result["correct"],
                  "written": sorted(os.path.abspath(p) for p in written)}))
"""


def child_env(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA", "TORCHINDUCTOR", "TRITON", "TORCH_EXTENSIONS"))}
    for var in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        (tmp_path / var).mkdir()
        env[var] = str(tmp_path / var)
    env["PYTHONPATH"] = str(ROOT)
    return env


@pytest.mark.parametrize("cell,trace", [("tiny_r50.serve_b1", "1"), ("tiny_r50.train_b4", "0")])
def test_run_loads_and_writes_only_its_own(tiny_root, tmp_path, cell, trace):
    env = child_env(tmp_path)
    res = subprocess.run([sys.executable, "-c", CHILD, str(tiny_root), cell, trace],
                         capture_output=True, text=True, env=env, cwd=tiny_root, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == [] and out["correct"] is True
    allowed = [Path(tiny_root).resolve()] + [Path(env[v]).resolve()
                                            for v in ("HOME", "XDG_CACHE_HOME", "TMPDIR")]
    for path in out["written"]:
        p = Path(path).resolve()
        assert p.parts[:2] == ("/", "dev") or any(p.is_relative_to(a) for a in allowed), path


def test_reference_imports_nothing_of_the_port():
    code = ("import sys, portbench.reference.pairnet, portbench.reference.train, "
            "portbench.reference.post, portbench.reference.init, portbench.counts.flops; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    loaded = set(json.loads(res.stdout.replace("'", '"')))
    assert "pairnet_torch" not in loaded and not loaded & {"jax", "jaxlib", "flax", "orbax",
                                                           "pairnet_tpu"}


def test_guard_compares_whole_top_level_names(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                               "orbax", "pairnet_tpu")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "pairnet_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pairnet_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert forbidden_modules() == ["jax", "pairnet_tpu.models"]


def test_command_refuses_without_a_card():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "pairnet_r50.serve_b1", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA device" in res.stderr
