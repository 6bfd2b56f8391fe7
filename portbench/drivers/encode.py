"""Segment encode: frames from the host, through ``VideoCodec``, to the binary container.

Per segment: ``VideoCodec(cfg, frames, device="cuda")`` (which uploads the
clip), ``.encode(compute_ssim=False, package=False)``, then
``.transmit_bitstream_binary(path)``: one file, overwritten each segment
(a kept segment is written to a file of its own, for the comparison), held
in memory (``Driver.memory_file``).  The segment ends when its container
is written.
"""
from __future__ import annotations

from portbench.drivers.base import Driver


class Encode(Driver):
    kind = "encode"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.path = self.memory_file("segment")
        self.last_pkg = None

    def segment(self, slot: int, keep: bool, spans) -> dict:
        from streamoptima_tpu_torch import VideoCodec

        frames = self.ctx.pool[slot]["frames"]
        path = self.memory_file("kept") if keep else self.path
        with spans("upload"):
            codec = VideoCodec(self.ctx.cfg, frames, device=self.ctx.device)
        with spans("encode"):
            pkg = codec.encode(compute_ssim=False, package=False)
        with spans("write"):
            codec.transmit_bitstream_binary(path)
        self.last_pkg = pkg
        rec = {"frames": len(frames), "counters": {"fast_me_passes": list(pkg.get("fast_me_passes", []))}}
        if keep:
            rec["outputs"] = {"container_path": path, "recon": pkg["reconstructed frames"]}
        return rec

    def frame_info(self, slot: int) -> list[dict]:
        """The last encoded segment's frame types and split blocks per frame."""
        pkg = self.last_pkg
        return [{"type": int(ft), "nsplit": int(o["split"].sum())}
                for ft, o in zip(pkg["frame_type_seq"], pkg["per_frame"])]


DRIVER = Encode
