"""The counts from shapes: the MSDA bounds and the model FLOPs."""

import pytest

from portbench.counts import flops, msda
from portbench.tests.tiny import BACKBONES, TINY_HEAD

SHAPES = msda.encoder_shapes((800, 1344))  # 25x42, 50x84, 100x168: S = 22,050


def test_backward_bound_of_the_bf16_train_step():
    """PERF.md's kernel table, row 6: the MSDA backward at batch 4 (bf16
    values and weights, f32 locations and upstream gradient), 0.1045 ms."""
    nbytes = msda.backward_bytes(4, SHAPES, 8, 32, 3, 4)
    assert nbytes == 349_977_600
    least = msda.least_seconds(nbytes, msda.backward_ops(4, SHAPES, 8, 32, 3, 4))
    assert round(least * 1e3, 4) == 0.1045


def test_forward_bound_of_the_bf16_serving_batch():
    nbytes = msda.forward_bytes(8, SHAPES, 8, 32, 3, 4)
    assert nbytes == 8 * 22050 * 256 * 2 * 2 + 8 * 22050 * 96 * (8 + 2)
    assert msda.least_seconds(nbytes, msda.forward_ops(8, SHAPES, 8, 32, 3, 4)) == pytest.approx(
        nbytes / msda.HBM_BYTES_PER_S)


@pytest.mark.parametrize("backbone", sorted(BACKBONES))
def test_flops_scale_with_the_image(backbone):
    cfg = {"backbone": BACKBONES[backbone], "head": TINY_HEAD}
    small = flops.forward_flops_per_image(cfg, (64, 96))
    large = flops.forward_flops_per_image(cfg, (128, 192))
    assert 0 < small < large < 5 * small
