"""The traffic generator gives the same inputs for the same seed, and other
inputs of the same sizes for another."""
import numpy as np
import pytest

from benchmark.harness import cell, checks
from benchmark.harness.traffic import make_video
from benchmark.tests import tiny


@pytest.mark.parametrize("name", ["depth24.depthpro", "netpass24.dav2"])
def test_same_seed_same_video(name):
    _, _, tr = tiny.tiny_cell(name)
    big = 2 ** 31 + 12345
    a, b = make_video(tr, big, 3, "cpu").numpy(), make_video(tr, big, 3, "cpu").numpy()
    c = make_video(tr, big + 1, 3, "cpu").numpy()
    assert a.dtype == np.uint8 and a.shape == (tr["frames"], tr["height"], tr["width"], 3)
    assert np.array_equal(a, b) and c.shape == a.shape and not np.array_equal(a, c)


@pytest.mark.parametrize("name", ["depth24.depthpro", "netpass24.dav2"])
def test_check_plan_is_drawn_from_the_seed(name):
    wl, _, tr = cell.load_cell(name)
    p, q = checks.plan(2 ** 40 + 7, tr, wl["check"]), checks.plan(2 ** 40 + 7, tr, wl["check"])
    assert p == q and len(p["pairs"]) == wl["check"]["pairs"]
    assert all(i in p["frames"] and j in p["frames"] and i != j for i, j in p["pairs"])
    assert 0 <= p["video"] < wl["check"]["videos"]
