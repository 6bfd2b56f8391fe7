"""Codec configuration.

The port's own copy of ``streamoptima_tpu.config``: the same fields, names
and validation for everything the PyTorch engine reads, so one dict of
keyword arguments builds either package's ``CodecConfig``.  Field names map
1:1 onto the reference's Y_Video_codec.__init__ parameters (Encoder.py:24).

Left out are the JAX engine's TPU-only tuning knobs (``me_search``, the
``fast_me_*`` knobs, ``winner_fetch``, ``encode_drain``, ``mesh_devices``):
they select among bit-identical TPU programs and have no meaning here.
``engine`` picks the engine: "jax" (the native engine, ``TorchCodec``) or
"compat" (the reference-exact engine, ``compat_engine.CompatCodec``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence


def parse_bitrate(target_br: str | int | None) -> int | None:
    """'<num> bps|kbps|mbps' -> bits/s (Encoder.py:78-88); ints pass through."""
    if target_br is None:
        return None
    if isinstance(target_br, (int, float)):
        return int(target_br)
    tokens = target_br.split(" ")
    num = int(tokens[0])
    unit = tokens[1]
    if unit == "kbps":
        return num * 1024
    if unit == "mbps":
        return num * 1048576
    return num


@dataclasses.dataclass
class CodecConfig:
    height: int
    width: int
    frames: int
    block_size: int = 16
    search_range: int = 16
    qp: int = 4
    intra_dur: int = 21
    intra_mode: int = 0
    lam: float | None = None
    vbs_enable: bool = False
    n_ref_frames: int = 1
    fast_me: bool = False
    fme_enable: bool = False
    rc_flag: int | None = None
    target_br: str | int | None = None
    frame_rate: int = 30
    qp_rate_tables: Sequence[Sequence[float]] | None = None
    intra_thresh: int | None = None
    parallel_mode: int = 0
    # "jax": the native engine; "compat": the engine bit-exact with the
    # NumPy reference (compat_engine.CompatCodec)
    engine: str = "jax"
    # text formatting: coefficient values serialized as np.int64(v) (what the
    # reference emits under numpy>=2).  None => True iff compat.
    numpy_repr_bitstream: bool | None = None
    # per-block QP offset map (ROI coding)
    roi_qp_map: Any = None
    # two-pass rate control
    two_pass: bool = False

    def __post_init__(self) -> None:
        if self.height % self.block_size or self.width % self.block_size:
            raise ValueError(
                "height/width must be multiples of block_size (the reference "
                "crashes on non-multiples; pad input frames first)"
            )
        if self.vbs_enable and self.lam is None:
            # the RD constant the reference's main.py uses (main.py:36)
            self.lam = 0.015
        if self.intra_mode not in (0, 1):
            raise ValueError("intra_mode must be 0 (horizontal) or 1 (vertical)")
        # the search packs the lexicographic tie-break as
        # (l1<<3 | ref)<<8 | dxi)<<8 | dyi: 3 bits of reference index and 8
        # bits per grid displacement index; out-of-range configs would
        # overflow the packing and silently pick wrong winners
        if not 1 <= self.n_ref_frames <= 8:
            raise ValueError("n_ref_frames must be in [1, 8] (3-bit ref field "
                             "in the search tie-break packing)")
        grid_sr = 2 * self.search_range if self.fme_enable else self.search_range
        if not 1 <= self.search_range or grid_sr > 127:
            raise ValueError(
                f"search_range {self.search_range} out of range: the ref-grid "
                f"range {grid_sr} must stay <= 127 (8-bit displacement-index "
                "fields in the search tie-break packing; under FME the grid "
                "range is 2*search_range)"
            )
        if self.engine not in ("jax", "compat"):
            raise ValueError("engine must be 'jax' or 'compat'")
        if self.roi_qp_map is not None and self.engine != "jax":
            raise ValueError("roi_qp_map is a native-engine feature (the reference's README "
                             "promises ROI but ships no implementation)")
        if self.rc_flag is not None and self.rc_flag > 1 and self.intra_thresh is None:
            # the engines compare every inter frame's size with it
            raise ValueError("scene-change promotion (rc_flag > 1) requires intra_thresh")
        if self.two_pass:
            if self.engine != "jax":
                raise ValueError("two_pass is a native-engine feature (the reference only gathers "
                                 "first-pass stats and discards them, Encoder.py:1627-1639)")
            if not (self.rc_flag is not None and self.rc_flag > 0 and self.target_br is not None
                    and self.qp_rate_tables is not None):
                raise ValueError("two_pass requires rate control (rc_flag>0, target_br, qp_rate_tables)")

    # ------------------------------------------------------------------ API
    @property
    def compat(self) -> bool:
        return self.engine == "compat"

    @property
    def sub_block_size(self) -> int:
        return self.block_size // 2

    @property
    def blocks_per_row(self) -> int:
        return self.width // self.block_size

    @property
    def block_rows(self) -> int:
        return self.height // self.block_size

    @property
    def n_blocks(self) -> int:
        return self.blocks_per_row * self.block_rows

    @property
    def target_bitrate(self) -> int | None:
        return parse_bitrate(self.target_br)

    @property
    def bitrate_per_row(self) -> float | None:
        """(bitrate // frame_rate) / (h / bs)  (Encoder.py:88)."""
        tb = self.target_bitrate
        if tb is None:
            return None
        return (tb // self.frame_rate) / (self.height / self.block_size)

    @property
    def rc_active(self) -> bool:
        return self.rc_flag is not None and self.rc_flag > 0

    @property
    def bitstream_numpy_repr(self) -> bool:
        if self.numpy_repr_bitstream is None:
            return self.compat
        return self.numpy_repr_bitstream

    @property
    def intra_canvas(self) -> tuple[int, int]:
        """Intra search canvas. The reference hardcodes a 288x352 all-128
        canvas (Encoder.py:1248, :1165) - frames smaller than CIF search into
        the 128 padding beyond the frame edge, and frames larger than CIF
        cannot be intra-coded at all by the reference.  Compat replicates the
        CIF canvas; the native engine uses the frame dims."""
        if self.compat:
            if self.height > 288 or self.width > 352:
                raise ValueError(
                    "compat engine replicates the reference's hardcoded "
                    "288x352 intra canvas (Encoder.py:1248) and cannot intra-"
                    "code larger frames; use engine='jax'"
                )
            return (288, 352)
        return (self.height, self.width)
