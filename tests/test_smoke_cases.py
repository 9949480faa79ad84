"""The reduced-size cases ``chip_smoke.py`` runs on the GPU against a
float64 CPU reference, here float32 against float64 both on the CPU, at
their small sizes (≤ 48³), with the tolerances the smoke run uses."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("name", sorted(chip_smoke.REFERENCE_CASES))
def test_float32_matches_float64_reference(name):
    ref = chip_smoke.run_case(name, "float64", small=True)
    got = chip_smoke.run_case(name, "float32", small=True)
    assert all(v.dtype == np.float64 for v in ref.values())
    assert all(v.dtype == np.float32 for v in got.values())
    diffs, ok = chip_smoke.compare(name, got, ref)
    assert ok, (diffs, chip_smoke.REFERENCE_CASES[name][1])


def test_compare_fails_on_nan_and_on_excess():
    ref = {"u": np.zeros(4)}
    assert chip_smoke.compare("nonhydro", {"u": np.zeros(4)}, ref)[1]
    assert not chip_smoke.compare(
        "nonhydro", {"u": np.full(4, np.nan, np.float32)}, ref)[1]
    assert not chip_smoke.compare(
        "nonhydro", {"u": np.full(4, 1e-4, np.float32)}, ref)[1]
