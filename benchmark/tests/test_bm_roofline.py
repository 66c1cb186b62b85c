"""The ε-schedule work count and the roofline arithmetic, by hand."""

import math

import pytest

from benchmark import roofline
from benchmark.reference.schedule import epsilon_schedule


def test_schedule_by_hand():
    # p = 2, diameter 2, blur 0.5, scaling 0.5: 4, then exp(arange(log 4,
    # log 0.25, log 0.25)) = 4, 1, then 0.25.
    assert epsilon_schedule(2, 2.0, 0.5, 0.5) == pytest.approx([4.0, 4.0, 1.0, 0.25])


def test_work_by_hand():
    # Four temperatures: 1 + 4 + 1 sweeps of 2 x 2 xy pairs and two
    # triangles of 3, then the gradient's 4 + 3: 6 * 10 + 7 = 67.
    call = dict(p=2, diameter=2.0, blur=0.5, scaling=0.5)
    exps, nbytes = roofline.online_work(2, 2, 3, call)
    assert exps == 67
    # x and y read (2 x 3 float32 each), the value and the gradient written.
    assert nbytes == 4 * 12 + 4 + 4 * 6


def test_least_time_by_hand():
    card = "NVIDIA H100 80GB HBM3"
    rate = roofline.exp_rate(card, 1.98e9)
    assert rate == pytest.approx(132 * 1.98e9 * (16 + 128 / 6))
    # Exponentials bound it at the benchmark's size ...
    call = dict(p=2, diameter=2.0, blur=0.05, scaling=0.5)
    exps, nbytes = roofline.online_work(100_000, 100_000, 3, call)
    assert len(epsilon_schedule(2, 2.0, 0.05, 0.5)) == 8
    assert exps == 10 * (10**10 + 2 * (100_000 * 100_001 // 2)) + 10**10 + 100_000 * 100_001 // 2
    assert roofline.least_seconds(exps, nbytes, card, 1.98e9) == pytest.approx(exps / rate)
    # ... bytes where there is no pair work to speak of.
    assert roofline.least_seconds(1, 3.35e12, card, 1.98e9) == pytest.approx(1.0)
    # No figures, no roofline (never a 0 %).
    assert roofline.least_seconds(exps, nbytes, "NVIDIA A100-SXM4-80GB", 1.41e9) is None
    assert roofline.least_seconds(exps, nbytes, card, None) is None
    assert math.isfinite(exps / rate)
