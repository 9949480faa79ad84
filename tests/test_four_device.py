"""The four-device comparisons of ``chip_smoke.py --four-gpus`` on four
virtual CPU devices, at small sizes, in float32 as on the card."""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

SMALL = {"dist_explicit_halo": (16, 16, 16), "dist_gspmd": (16, 16, 16),
         "dist_cubed_sphere": (8, 4)}


@pytest.mark.parametrize("fn", chip_smoke.FOUR_DEVICE_CASES,
                         ids=lambda f: f.__name__)
def test_four_devices_match_one(fn):
    with chip_smoke.float_type("float32"):
        rec = chip_smoke.judge_four(
            fn(jax.devices()[:4], size=SMALL[fn.__name__], steps=3))
    assert rec["ok"], rec
    assert rec["devices"] == 4
    assert rec["max_device_share"] <= 0.35


def test_judge_four_rejects_one_device_and_large_differences():
    base = {"devices": 4, "max_device_share": 0.25,
            "rel_diff": {"u": 1e-6}}
    assert chip_smoke.judge_four(dict(base))["ok"]
    assert not chip_smoke.judge_four({**base, "devices": 1})["ok"]
    assert not chip_smoke.judge_four({**base, "max_device_share": 1.0})["ok"]
    assert not chip_smoke.judge_four({**base, "rel_diff": {"u": 0.5}})["ok"]
