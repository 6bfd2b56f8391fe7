"""Segment decode: binary containers, through ``VideoCodec``, to frames on the host.

Set-up encodes every pool segment once with the program (as the encode
traffic does) and keeps its container as a file held in memory
(``Driver.memory_file``).  Per
segment the window calls ``decode_bitstream_binary(path)`` on one decoder,
``VideoCodec(cfg, device="cuda")``, built in set-up; the segment ends when
its frames are a numpy array on the host.  No search runs.  The traced
slice calls the same work in its two steps, ``binstream.read_binary`` and
``VideoCodec.decode``, so that each has a span.
"""
from __future__ import annotations

from portbench.drivers.base import Driver


class Decode(Driver):
    kind = "decode"

    def setup(self) -> None:
        from streamoptima_tpu_torch import VideoCodec

        self.paths = []
        for slot, seg in enumerate(self.ctx.pool):
            enc = VideoCodec(self.ctx.cfg, seg["frames"], device=self.ctx.device)
            enc.encode(compute_ssim=False, package=False)
            path = self.memory_file(f"pool-{slot}")
            enc.transmit_bitstream_binary(path)
            self.paths.append(path)
        self.codec = VideoCodec(self.ctx.cfg, device=self.ctx.device)
        self.last_mvs = None

    def setup_outputs(self) -> dict:
        """The containers set-up wrote, by slot: the program's encode, for the comparison."""
        return {slot: {"container_path": path} for slot, path in enumerate(self.paths)}

    def segment(self, slot: int, keep: bool, spans) -> dict:
        path = self.paths[slot]
        if not spans.traced:
            frames = self.codec.decode_bitstream_binary(path)
        else:
            from streamoptima_tpu_torch import binstream

            with spans("read"):
                fts, mvs, qps, res = binstream.read_binary(path, self.codec.cfg)
            with spans("decode"):
                frames = self.codec.decode(fts, res, qps, mvs)
            self.last_mvs = (fts, mvs)
        rec = {"frames": len(frames), "counters": {}}
        if keep:
            rec["outputs"] = {"decoded": frames}
        return rec

    def frame_info(self, slot: int) -> list[dict]:
        fts, mvs = self.last_mvs
        return [{"type": int(ft), "nsplit": int(m.split.sum())} for ft, m in zip(fts, mvs)]


DRIVER = Decode
