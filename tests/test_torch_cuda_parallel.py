"""The port's collectives on CUDA tensors under NCCL, at world size 1 (one
card is all a test machine is sure to have).

Marked ``cuda``: they need an NVIDIA GPU, and skip without one. They import
torch only, so on a GPU machine without JAX:
``python -m pytest --noconftest tests/test_torch_cuda_parallel.py -m cuda``.
"""

from datetime import timedelta

import pytest
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from pairnet_torch.models.necks.pixel_decoder import DeformableEncoderLayer  # noqa: E402
from pairnet_torch.models.layers import encoder_reference_points  # noqa: E402
from pairnet_torch.ops.deform_attn_exact import deform_attn_exact  # noqa: E402
from pairnet_torch.parallel import mesh  # noqa: E402
from pairnet_torch.parallel.spatial import gather_tokens, sequence_parallel_encoder  # noqa: E402

SHAPES = ((10, 16), (5, 8), (3, 4))


@pytest.fixture
def nccl(tmp_path):
    """A one-rank NCCL group on cuda:0 (a FileStore: no port)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, timeout=timedelta(seconds=60), device_id=dev)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_coalesced_all_reduce_on_cuda(nccl):
    """One NCCL all_reduce per dtype, values unchanged at world size 1."""
    calls = []
    orig = dist.all_reduce

    def counted(t, *a, **k):
        calls.append((t.dtype, t.device.type))
        return orig(t, *a, **k)

    g = torch.Generator(device=nccl).manual_seed(0)
    tensors = [torch.randn((64, 33), generator=g, device=nccl),
               torch.randn((7,), generator=g, device=nccl).bfloat16(),
               torch.randn((3, 5), generator=g, device=nccl)]
    want = [t.clone() for t in tensors]
    dist.all_reduce = counted
    try:
        mesh.all_reduce_coalesced(tensors)
        arrays = mesh.all_reduce_arrays({"a": [[1.5, 2.0]]})
    finally:
        dist.all_reduce = orig
    torch.cuda.synchronize()
    assert sorted(calls, key=str) == sorted([(torch.float32, "cuda"), (torch.bfloat16, "cuda"),
                                             (torch.float64, "cuda")], key=str)
    for t, w in zip(tensors, want):
        assert torch.equal(t, w)
    assert arrays["a"].tolist() == [[1.5, 2.0]]
    assert mesh.collective_device() == nccl


@pytest.mark.cuda
def test_token_gather_and_its_backward_on_cuda(nccl):
    """The plane's all-gather and its reduce-scatter backward are the
    identity at world size 1, on CUDA tensors."""
    group = dist.group.WORLD
    x = torch.randn((2, 24, 4, 8), device=nccl, requires_grad=True)
    out = gather_tokens(x, group)
    assert out.shape == x.shape and torch.equal(out, x)
    g = torch.randn_like(out)
    out.backward(g)
    torch.cuda.synchronize()
    assert torch.equal(x.grad, g)


@pytest.mark.cuda
def test_sequence_parallel_encoder_on_cuda(nccl):
    """A 2-layer encoder through ``sequence_parallel_encoder`` on a group of
    one equals the same layers run plainly, through the exact MSDA kernel
    (4 launches: 2 layers, twice)."""
    group = dist.group.WORLD
    torch.manual_seed(0)
    plain = [DeformableEncoderLayer(32, 4, 3, 4, 64).to(nccl) for _ in range(2)]
    sp = [DeformableEncoderLayer(32, 4, 3, 4, 64, seq_group=group).to(nccl) for _ in range(2)]
    for a, b in zip(plain, sp):
        b.load_state_dict(a.state_dict())
    S = sum(h * w for h, w in SHAPES)
    x = torch.randn((2, S, 32), device=nccl)
    pos = torch.randn((2, S, 32), device=nccl) * 0.1
    ref = encoder_reference_points(SHAPES, device=nccl)[None]
    deform_attn_exact.launches = 0
    with torch.no_grad():
        want = x
        for layer in plain:
            want = layer(want, pos, ref, SHAPES)
        got = sequence_parallel_encoder(sp, x, pos, ref, SHAPES, group)
    torch.cuda.synchronize()
    assert deform_attn_exact.launches == 4
    assert torch.equal(got, want)
