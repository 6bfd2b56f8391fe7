"""The traffic generator: a pool of distinct segments made from the seed.

A segment is a clip of a smoothed random texture that translates by a
constant (dx, dy) pixels a frame: the port's ``utils.clips.synthetic_clip``
(copied here, so that the yardstick does not move with the program),
extended to motion in both directions and either sign.  The traffic file
fixes the set of motions; the seed picks each segment's texture and the
order in which the motions are dealt to the pool's slots, so every seed
gives the same amount of motion-search work in another arrangement.

A traffic file may list scene ``cuts``: frame indices at which every
segment of the pool switches to a fresh texture, which keeps the segment's
motion.  The fresh textures come from a seed stream of their own, so a cut
changes neither the first texture's draws nor the slots' order, and a
traffic without cuts gives the pool it always gave.
"""
from __future__ import annotations

import numpy as np

#: a texture's random draws are seeded from (seed, slot) through numpy's SeedSequence
_TEXTURE_STREAM = 0x7E47
#: the textures after a scene cut: from (seed, slot, cut), a stream apart from the first textures' and the order's
_CUT_STREAM = 0x7E49


def texture_clip(h: int, w: int, frames: int, dx: int, dy: int, rng: np.random.Generator, smooth: int = 5,
                 max_motion: int = 8) -> np.ndarray:
    """(frames, h, w) uint8: a texture translating by (dx, dy) px/frame,
    |dx|, |dy| <= ``max_motion``.  The texture is uniform noise blurred by a
    separable ``smooth``-tap box filter (``synthetic_clip``'s), wrapped to
    [0, 255] by clipping."""
    if max(abs(dx), abs(dy)) > max_motion:
        raise ValueError(f"motion ({dx}, {dy}) exceeds {max_motion} px/frame")
    reach = max_motion * (frames - 1)
    pad = 2 * reach + 16
    base = rng.integers(0, 256, size=(h + pad, w + pad)).astype(np.float64)
    if smooth > 1:
        kernel = np.ones(smooth) / smooth
        base = np.apply_along_axis(lambda r: np.convolve(r, kernel, mode="same"), 0, base)
        base = np.apply_along_axis(lambda r: np.convolve(r, kernel, mode="same"), 1, base)
    base = np.clip(base, 0, 255).astype(np.uint8)
    y0 = x0 = reach + 8
    return np.stack([base[y0 + i * dy: y0 + i * dy + h, x0 + i * dx: x0 + i * dx + w].copy()
                     for i in range(frames)])


def segment_pool(h: int, w: int, traffic: dict, seed: int) -> list[dict]:
    """The pool of ``traffic["pool"]`` segments of ``traffic["frames"]``
    frames each: [{"frames": (n, h, w) uint8, "motion": (dx, dy)}], slot by
    slot.  ``traffic["motions"]`` lists one (dx, dy) per slot; the seed
    permutes them over the slots and draws every texture.  From each frame
    that ``traffic["cuts"]`` lists on, a segment shows a fresh texture at
    the place where it would have moved to by then."""
    motions = [tuple(int(v) for v in m) for m in traffic["motions"]]
    if len(motions) != traffic["pool"]:
        raise ValueError(f"the traffic lists {len(motions)} motions for a pool of {traffic['pool']}")
    frames = traffic["frames"]
    cuts = [int(c) for c in traffic.get("cuts", [])]
    if cuts != sorted(set(cuts)) or not all(0 < c < frames for c in cuts):
        raise ValueError(f"cuts {cuts} must rise strictly within frames 1..{frames - 1}")
    ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(seed) >> 32, _TEXTURE_STREAM])
    order = np.random.default_rng(ss.spawn(1)[0]).permutation(len(motions))
    cut_slots = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(seed) >> 32, _CUT_STREAM]).spawn(len(motions))
    smooth, max_motion = traffic.get("smooth", 5), traffic.get("max_motion", 8)
    pool = []
    for slot, child in enumerate(ss.spawn(len(motions) + 1)[1:]):
        dx, dy = motions[order[slot]]
        clip = texture_clip(h, w, frames, dx, dy, np.random.default_rng(child), smooth, max_motion)
        for cut, cut_child in zip(cuts, cut_slots[slot].spawn(len(cuts))):
            clip[cut:] = texture_clip(h, w, frames, dx, dy, np.random.default_rng(cut_child), smooth, max_motion)[cut:]
        pool.append({"frames": clip, "motion": (dx, dy)})
    return pool


def schedule(traffic: dict, seed: int):
    """The window's order of pool slots: the slots in a seeded order,
    repeated without end (a closed loop of one stream)."""
    ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(seed) >> 32, _TEXTURE_STREAM + 1])
    order = np.random.default_rng(ss).permutation(traffic["pool"])
    while True:
        yield from (int(s) for s in order)
