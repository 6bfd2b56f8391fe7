"""How ``correct`` is decided: the program's outputs against the plain reference.

Once the window has closed, the reference (``portbench/reference``)
encodes the pool segments that the sample drew, from the same frames, on
the card.  Each kept segment's outputs are compared with it exactly: the
container's bytes (the serializer, and through it every MV, split flag and
coefficient), the encoder's reconstructions (the frames later frames
predict from) and, in the decode traffic, the decoded frames.  The codec
is bit-exact by its configuration, so every limit is 0.

The configurations the reference runs: intra mode 0, one to eight
references, VBS and half-pel FME each on or off, full search or fast ME,
at a constant QP or under rate control (per-row QPs, scene-change
promotion, two-pass), on traffic with or without scene cuts.  It refuses
ROI maps, the parallel modes, intra mode 1 and the compat engine, so a
configuration that states one of those cannot have a cell yet.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from portbench.harness.generator import schedule

#: the numbers compared, each with its limit: an exact comparison has the limit 0
LIMITS = {"container_bytes_differing": 0, "recon_pixels_differing": 0, "decoded_pixels_differing": 0}


def bytes_differing(a: bytes, b: bytes) -> int:
    """Positions at which two byte strings differ, the length difference included."""
    n = min(len(a), len(b))
    x = np.frombuffer(a[:n], np.uint8)
    y = np.frombuffer(b[:n], np.uint8)
    return int((x != y).sum()) + abs(len(a) - len(b))


def pixels_differing(a, b) -> int:
    """Pixels at which two clips differ; a clip of another shape differs everywhere."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int((a != b).sum())


def reference_slots(traffic: dict, seed: int) -> set:
    """The pool slots the reference encodes: the first ``reference_slots``
    of the window's seeded order, so that the window's first segments hold
    one of each."""
    order = schedule(traffic, seed)
    return {next(order) for _ in range(traffic["reference_slots"])}


def compare(observed: list, reference: dict) -> dict:
    """``observed``: [(slot, outputs)], outputs holding any of
    "container_path" (or the "container" bytes), "recon" and "decoded";
    ``reference``: slot -> (container bytes, reconstructions).  Returns
    {number: value} for the numbers these outputs allow."""
    out: dict[str, int] = {}
    for slot, o in observed:
        ref_bytes, ref_recon = reference[slot]
        if "container_path" in o or "container" in o:
            got = o["container"] if "container" in o else Path(o["container_path"]).read_bytes()
            out["container_bytes_differing"] = out.get("container_bytes_differing", 0) + bytes_differing(got, ref_bytes)
        if "recon" in o:
            out["recon_pixels_differing"] = out.get("recon_pixels_differing", 0) + pixels_differing(o["recon"],
                                                                                                  ref_recon)
        if "decoded" in o:
            out["decoded_pixels_differing"] = out.get("decoded_pixels_differing", 0) + pixels_differing(
                o["decoded"], ref_recon)
    return out


def reference_outputs(cfg: dict, pool: list, slots, device, control: bool = False) -> dict:
    """The reference's (container bytes, reconstructions) of each pool slot
    in ``slots``; ``control`` puts its float32 transforms in place of the
    exact ones (the lower-precision control)."""
    import torch

    from portbench.reference import ReferenceEncoder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    enc = ReferenceEncoder(cfg, device, control=control)
    return {slot: enc.encode(pool[slot]["frames"]) for slot in sorted(set(slots))}
