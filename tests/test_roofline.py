"""The roofline phase harness must build and run on any backend (the SoL
percentages are only meaningful on a real chip, but the phase programs and
the analytic accounting must stay correct)."""
import numpy as np
import pytest

from recsys_tpu.tools import roofline


def test_roofline_phases_compile_and_run():
    phases, analytic = roofline.build_phases(64, np.random.default_rng(0))
    assert set(phases) == {"gather", "dense", "scatter", "update", "fused_bwd"}
    for name, (fn, carry) in phases.items():
        ms = roofline.time_chained(fn, carry, iters=2)
        assert ms > 0, name


def test_roofline_analytic_accounting():
    _, analytic = roofline.build_phases(128, np.random.default_rng(0))
    # dense Adam moves 7x table bytes; the gather only touches batch rows
    assert analytic["update"]["bytes"] > analytic["gather"]["bytes"]
    # gather traffic = lookups * one 512-byte physical row
    assert analytic["gather"]["bytes"] == 128 * 26 * 512
    assert analytic["dense"]["flops"] > 0 and analytic["dense"]["bytes"] == 0
    # scatter includes the cotangent read plus touched-row read-modify-write
    assert analytic["scatter"]["bytes"] > analytic["gather"]["bytes"]


def test_roofline_peaks_table_has_h100_and_rejects_unknown():
    h100 = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert h100 == {"bf16_flops": 989e12, "hbm_bw": 3.35e12}
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.peaks("cpu")


def test_roofline_share_names_its_bound():
    kind = "NVIDIA H100 80GB HBM3"
    # 3.35 GB at 3.35 TB/s is 1 ms of memory time: half of a 2 ms kernel
    mem = roofline.roofline_share(kind, 3.35e9, 0.0, 2.0)
    assert mem["bound"] == "memory" and abs(mem["share"] - 0.5) < 1e-12
    flops = roofline.roofline_share(kind, 0.0, 989e9, 4.0)
    assert flops["bound"] == "flops" and abs(flops["share"] - 0.25) < 1e-12
    with pytest.raises(ValueError):
        roofline.roofline_share("Unknown Accelerator", 1.0, 1.0, 1.0)
