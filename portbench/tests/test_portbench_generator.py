"""The traffic generator: the same seed gives the same pool and order; every seed deals
the same motions; large seeds work."""
from __future__ import annotations

import itertools
import json

import numpy as np
import pytest

from conftest import REPO
from portbench.harness.correct import reference_slots
from portbench.harness.generator import schedule, segment_pool, texture_clip
from portbench.harness.window import sample_picker

TRAFFIC = json.loads((REPO / "portbench/traffic/segments-encode.json").read_text())
SEEDS = [0, 7, 2**31 + 11, 2**40 + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_pool_repeats_per_seed(seed):
    a = segment_pool(32, 48, TRAFFIC, seed)
    b = segment_pool(32, 48, TRAFFIC, seed)
    assert [s["motion"] for s in a] == [s["motion"] for s in b]
    assert all(np.array_equal(x["frames"], y["frames"]) for x, y in zip(a, b))
    assert list(itertools.islice(schedule(TRAFFIC, seed), 30)) == list(itertools.islice(schedule(TRAFFIC, seed), 30))
    assert reference_slots(TRAFFIC, seed) == reference_slots(TRAFFIC, seed)


def test_seeds_deal_the_same_motions_in_another_order():
    pools = [segment_pool(32, 48, TRAFFIC, s) for s in SEEDS]
    motions = [[s["motion"] for s in p] for p in pools]
    assert all(sorted(m) == sorted(map(tuple, TRAFFIC["motions"])) for m in motions)
    assert len({tuple(m) for m in motions}) > 1
    assert not np.array_equal(pools[0][0]["frames"], pools[1][0]["frames"])


def test_segments_move_as_drawn():
    clip = texture_clip(32, 48, 6, -3, 2, np.random.default_rng(1))
    assert clip.shape == (6, 32, 48) and clip.dtype == np.uint8
    for i in range(5):  # frame i + 1 is frame i moved by (dx, dy) = (-3, 2): content shifts by (+3, -2)
        assert np.array_equal(clip[i + 1][:-2, 3:], clip[i][2:, :-3])
    with pytest.raises(ValueError):
        texture_clip(32, 48, 4, 9, 0, np.random.default_rng(0))


def test_schedule_cycles_the_pool():
    order = list(itertools.islice(schedule(TRAFFIC, 5), 3 * TRAFFIC["pool"]))
    first = order[: TRAFFIC["pool"]]
    assert sorted(first) == list(range(TRAFFIC["pool"]))
    assert order == first * 3


def test_sample_keeps_each_reference_slot_and_repeats_per_seed():
    slots = reference_slots(TRAFFIC, 9)
    picks = []
    for _ in range(2):
        keep = sample_picker(TRAFFIC, slots, 9)
        order = schedule(TRAFFIC, 9)
        picks.append([(s, keep(s)) for s in itertools.islice(order, 200)])
    assert picks[0] == picks[1]
    kept = [s for s, k in picks[0] if k]
    assert set(kept) == slots and len(kept) <= TRAFFIC["max_samples"]
