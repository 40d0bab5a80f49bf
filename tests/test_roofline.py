"""utils/roofline.py: the peak table, HLO-shape byte accounting and the
frame cost model."""

import pytest

from skele_raytracer_tpu.utils import roofline

H100 = "NVIDIA H100 80GB HBM3"


def test_op_bytes_padding():
    # one read or write of each named array, no layout padding
    long_name = "fusion.1 = f32[1000,3]{1,0} fusion(f32[1000,16]{1,0})"
    assert roofline.op_bytes(long_name) == 1000 * 3 * 4 + 1000 * 16 * 4


def test_op_bytes_scalar_and_1d():
    b = roofline.op_bytes("x = f32[] add(f32[131072]{0}, pred[7]{0})")
    assert b == 4 + 131072 * 4 + 7


def test_frame_model_headline_magnitudes():
    m = roofline.frame_model(
        width=1920, height=1080, paths=16, depth=2, s_pad=16
    )
    assert m["segments"] == 1920 * 1080 * 17
    # ~1 kFLOP/segment; ids in + radiance out per sample
    assert 20e9 < m["flops"] < 60e9
    assert m["hbm_bytes_min"] == 1920 * 1080 * (16 + 12)

    s = roofline.sol_summary(m, 0.002, roofline.peaks(H100))
    assert s["bound"] in ("fp32", "hbm")
    assert 0 < s["fp32_sol_pct"] < 100
    assert s["achieved_tflops"] > 0


def test_sol_summary_bound_flips():
    # huge flops, tiny bytes -> fp32-bound; reverse -> hbm-bound
    peak = roofline.peaks(H100)
    fp = roofline.sol_summary({"flops": 1e15, "hbm_bytes_min": 1}, 1.0, peak)
    hbm = roofline.sol_summary({"flops": 1.0, "hbm_bytes_min": 1e12}, 1.0, peak)
    assert fp["bound"] == "fp32" and hbm["bound"] == "hbm"


def test_h100_peaks_from_data_sheet():
    p = roofline.peaks(H100)
    assert p == {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12,
                 "hbm": 3.35e12}


def test_unknown_device_is_an_error():
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.peaks("Example Accelerator 9000")
