"""Shapes and frame bookkeeping that the kernel counts share."""
from __future__ import annotations


def dims(cfg: dict) -> tuple[int, int, int, int, int]:
    """(h, w, bs, nb, px) of a configuration."""
    h, w, bs = cfg["height"], cfg["width"], cfg.get("block_size", 16)
    return h, w, bs, (h // bs) * (w // bs), h * w


def nth_frame(frames: list, nth: int, ftype: int | None = None) -> int | None:
    """The index of the ``nth`` frame (of type ``ftype``, if given), or None."""
    idx = [i for i, f in enumerate(frames) if ftype is None or f["type"] == ftype]
    return idx[nth] if 0 <= nth < len(idx) else None


def refs_at(frames: list, i: int, nref: int) -> int:
    """References an inter frame ``i`` predicts from: the frames since the
    last intra frame, at most ``nref``."""
    last = max((j for j in range(i + 1) if frames[j]["type"] == 0), default=None)
    return 1 if last is None else max(1, min(i - last, nref))
