"""The yardstick's arithmetic against the figures the port's bring-up
measured against (PERF.md's kernel table, D0@512, 90 classes, 49,104
anchors), and the FLOP count against a hand count."""
import pytest
import torch

from port_bench import run as bench_run
from port_bench import yardstick as ys
from port_bench.reference.model import EfficientDet

A = 49104


def test_k2_bound_is_its_bytes():
    assert ys.k2_bound_s(128, A, 90) * 1e3 == pytest.approx(0.3527, abs=1e-4)
    assert ys.k2_bound_s(16, A, 90) * 1e3 == pytest.approx(0.0441, abs=1e-4)


def test_k1_bound_counts_its_iterations():
    # 100 picks an image: every image runs all 100 iterations
    it = ys.k1_iterations([100] * 128, 100)
    assert it == 12800
    assert ys.k1_bound_s(it, 128, 5000, 100) * 1e3 == pytest.approx(
        0.03821, abs=1e-5)
    assert ys.k1_bound_s(ys.k1_iterations([100] * 16, 100), 16, 5000,
                         100) * 1e3 == pytest.approx(0.00478, abs=1e-5)
    # an image that ran out after 7 picks ran 8 iterations
    assert ys.k1_iterations([7, 100], 100) == 108


def test_k3_bound_counts_valid_pairs_and_meetings():
    # PR 4's B = 32 case: 31 images of 16 rows (one all padding), 4.29 %
    # of the valid pairs meet
    pairs = 496 * A
    meets = round(0.0429 * pairs)
    assert ys.k3_bound_s(A, 32, 100, 496, meets) * 1e3 == pytest.approx(
        0.00749, abs=2e-5)


def test_k4_bound_is_its_bytes():
    assert ys.k4_bound_s(A, 128, 100, 128 * 40) * 1e3 == pytest.approx(
        0.06037, abs=1e-4)
    assert ys.k4_bound_s(A, 32, 100, 32 * 40) * 1e3 == pytest.approx(
        0.01527, abs=1e-4)


def test_meeting_pairs_counts_boxes_that_touch():
    anchors = torch.tensor([[0., 0., 10., 10.], [20., 20., 30., 30.]])
    gt = torch.tensor([[[5., 5., 15., 15.], [40., 40., 50., 50.]]])
    valid = torch.tensor([[True, True]])
    assert ys.meeting_pairs(anchors, gt, valid) == 1
    assert ys.meeting_pairs(anchors, gt, torch.tensor([[False, True]])) == 0


def test_flops_of_one_conv_and_one_separable_block():
    x = torch.randn(2, 8, 16, 16, requires_grad=True)
    w = torch.randn(12, 8, 3, 3, requires_grad=True)
    conv = lambda: torch.nn.functional.conv2d(x, w, padding=1)
    macs = 2 * 12 * 16 * 16 * 8 * 9
    assert ys.count_flops(conv) == 2 * macs
    assert ys.count_flops(lambda: conv().sum().backward()) == 6 * macs
    dw = torch.randn(8, 1, 3, 3, requires_grad=True)
    pw = torch.randn(12, 8, 1, 1, requires_grad=True)

    def block():
        y = torch.nn.functional.conv2d(x, dw, padding=1, groups=8)
        return torch.nn.functional.conv2d(y, pw)
    dw_macs, pw_macs = 2 * 8 * 16 * 16 * 9, 2 * 12 * 16 * 16 * 8
    assert ys.count_flops(block) == 2 * (dw_macs + pw_macs)
    # backward: both gradients of each conv, the depthwise weight's counted
    # once (not once a channel)
    assert ys.count_flops(lambda: block().sum().backward()) == \
        6 * (dw_macs + pw_macs)


def test_model_flops_on_the_meta_device():
    cfg = bench_run.load_json(bench_run.ROOT /
                              "configs/efficientdet_d0.json")["model"]
    fwd = ys.model_flops(EfficientDet, cfg, 1, train=False)
    # 2.5 GMAC an image at 512 px (Tan et al., Table 1: 2.5 B FLOPs, which
    # counts multiply-adds)
    assert fwd / 2 == pytest.approx(2.49e9, rel=0.02)
    assert ys.model_flops(EfficientDet, cfg, 2, train=False) == 2 * fwd


def test_share_is_none_without_a_time():
    assert ys.share(1.0, 0.0) is None
    assert ys.share(1.0, 2.0) == 50.0
