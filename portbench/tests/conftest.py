"""Fixtures of the harness's tests: a tiny copy of the benchmark (see
``tiny.py``) and the card, where there is one."""

import pytest
import torch

from portbench.tests.tiny import make_root


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("portbench"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda:0"
