"""The traffic generator: the same seed gives the same pool and order; every seed deals
the same motions; large seeds work; scene cuts switch the texture and keep the motion,
and a traffic without cuts gives the pool it gave before cuts existed."""
from __future__ import annotations

import hashlib
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


#: SHA-256 of each 32x48 pool (motions, then frames, slot by slot), computed before the generator took
#: cuts; the encode and decode traffic files deal the same textures and motions
POOL_DIGESTS = {0: "3c3d09e9217c422e2c98fd12eab6db21d91f5f0fe984d83f1eedc07206901120",
                7: "80e80be8cfb9655c816ce1979b2ab8b0466a2dd7ca3b2b789cc972bd7d148674",
                2**31 + 11: "a6947c19e4b836982e072da7ac5307d4e246e019cf20b5c47565731363424180",
                2**40 + 3: "326eb80c20c77b5f6f615e7b921af5756b3ab41d03a6e4933446f1d17b8d898f"}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["segments-encode", "segments-decode"])
def test_a_pool_without_cuts_is_unchanged(name, seed):
    base = json.loads((REPO / f"portbench/traffic/{name}.json").read_text())
    for traffic in (base, dict(base, cuts=[])):
        h = hashlib.sha256()
        for seg in segment_pool(32, 48, traffic, seed):
            h.update(np.asarray(seg["motion"], np.int64).tobytes())
            h.update(seg["frames"].tobytes())
        assert h.hexdigest() == POOL_DIGESTS[seed]


@pytest.mark.parametrize("seed", [3, 2**36 + 1])
def test_cuts_switch_the_texture_and_keep_the_motion(seed):
    cuts = [3, 5]
    plain = segment_pool(32, 48, dict(TRAFFIC, frames=8), seed)
    cut = segment_pool(32, 48, dict(TRAFFIC, frames=8, cuts=cuts), seed)
    again = segment_pool(32, 48, dict(TRAFFIC, frames=8, cuts=cuts), seed)
    assert all(np.array_equal(a["frames"], b["frames"]) for a, b in zip(cut, again))
    for p, c in zip(plain, cut):
        assert c["motion"] == p["motion"]  # the slots' order and motions are the plain pool's
        assert np.array_equal(c["frames"][:3], p["frames"][:3])  # the first texture's draws are unchanged
        dx, dy = c["motion"]
        for i in range(7):
            moved = np.array_equal(c["frames"][i + 1][max(-dy, 0):32 - max(dy, 0), max(-dx, 0):48 - max(dx, 0)],
                                   c["frames"][i][max(dy, 0):32 - max(-dy, 0), max(dx, 0):48 - max(-dx, 0)])
            # within a scene each frame is the last one moved by (dx, dy); across a cut the texture is new
            assert moved == (i + 1 not in cuts)


def test_cuts_outside_the_segment_are_refused():
    for cuts in ([0], [16], [5, 5], [7, 4]):
        with pytest.raises(ValueError):
            segment_pool(32, 48, dict(TRAFFIC, cuts=cuts), 1)
