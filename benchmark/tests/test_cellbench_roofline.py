"""The yardstick's arithmetic against hand counts."""

import numpy as np
import pytest

import _setup  # noqa: F401
from cellbench import roofline

PEAKS = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
RATE = 132 * 64 * 1.98e9


def test_k1_bound_by_hand():
    # n = 4, M = 10: refs 8n+5 = 37, orig 16, costs 35 int32 words a row;
    # P's 1720 taps plus per pixel and mode 2 log2(4) + 2 = 6 instructions
    t, nbytes, ops = roofline.k1_bound(4, 10, PEAKS)
    assert nbytes == 10 * (37 + 16 + 35) * 4 == 3520
    assert ops == 10 * (1720 + 35 * 16 * 6) == 50800
    assert t == pytest.approx(max(3520 / 3.35e12, 50800 / RATE))


def test_k1_rows():
    assert roofline.k1_rows(240, 416, 32) == {
        n: 32 * (256 // n) * (448 // n) for n in (4, 8, 16, 32)}


def _tiny_map():
    # 16x32 luma: a TU16 over slots (0..1, 0..1), TU8s at column 2, four
    # TU4s in each slot of column 3
    tz = np.array([[[4, 4, 3, 2], [4, 4, 3, 2]]])
    return tz, np.ones_like(tz, bool)


def test_tu_counts_by_hand():
    tz, cd = _tiny_map()
    got = roofline.tu_counts(tz, cd)
    assert got[("y", 16)] == 1 and got[("y", 8)] == 2 and got[("y", 4)] == 8
    assert got[("y", 32)] == 0
    assert got[("c", 8)] == 1 and got[("c", 4)] == 2 + 2


def test_stage2_work_by_hand():
    tz, cd = _tiny_map()
    ops, nbytes = roofline.stage2_work(tz, cd, 16, 32)
    luma = 1 * 4 * 16**3 + 2 * 4 * 8**3 + 8 * 4 * 4**3
    chroma = 2 * (1 * 4 * 8**3 + 4 * 4 * 4**3)
    assert ops == luma + chroma == 28672
    assert nbytes == 16 * 32 * 3 // 2 * 4 == 3072
    assert roofline.stage2_bound(tz, cd, 16, 32, PEAKS) == pytest.approx(
        max(28672 / RATE, 3072 / 3.35e12))


def test_uncoded_slots_count_nothing():
    tz, cd = _tiny_map()
    assert roofline.stage2_work(tz, np.zeros_like(cd), 16, 32)[0] == 0


def test_stage1_transforms_by_hand():
    # one 64x64 frame: pass-2 candidates, the CU64's four TU32s at 6
    # candidates, the TU-tree sizes of each CU size, the chroma list on U
    # and V (hand-added from the encoder's loops)
    assert roofline.stage1_transform_macs(64, 64, 1) == 7520256
    assert roofline.stage1_transform_macs(64, 64, 3) == 3 * 7520256


def test_cnn_flops_by_hand():
    crop = (32 * 32 * 16 * 75 + 16 * 16 * 64 * 288 + 8 * 8 * 128 * 576
            + 2048 * 256 + 256 * 64 + 64 * 16)
    assert roofline.cnn_flops(64, 64, 1) == 2 * (4 * crop + 64 * 64 * 16 * 75)
    assert roofline.cnn_flops(240, 416, 2) == 2 * 28 * roofline.cnn_flops(
        64, 64, 1)


def test_step_bound_is_the_sum_of_its_parts():
    tz = np.full((1, 8, 8), 5)
    cd = np.ones_like(tz, bool)
    want = (roofline.cnn_flops(64, 64, 1) / 67e12
            + sum(roofline.k1_bound(n, m, PEAKS)[0]
                  for n, m in roofline.k1_rows(64, 64, 1).items())
            + 7520256 / RATE + roofline.stage2_bound(tz, cd, 64, 64, PEAKS))
    assert roofline.step_bound(64, 64, 1, tz, cd, PEAKS) == pytest.approx(want)
