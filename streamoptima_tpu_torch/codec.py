"""User-facing facade over ``TorchCodec``: metrics, bitstreams, file I/O.

Counterpart of ``streamoptima_tpu.codec.VideoCodec`` for the main path::

    codec = VideoCodec(cfg, y_frames, device="cuda")
    pkg = codec.encode()                              # PSNR + SSIM per frame, on the device
    codec.transmit_bitstream("mv.txt", "res.txt")     # text bitstream
    frames = VideoCodec(cfg, device="cuda").decode_bitstream("mv.txt", "res.txt")
    # or in two steps: decode(*parse_bitstream("mv.txt", "res.txt"))
    codec.transmit_bitstream_binary("clip.sob")       # one-file binary container
    frames = VideoCodec(cfg, device="cuda").decode_bitstream_binary("clip.sob")
    codec.save_decoded_frames("out.yuv", overlay_path="vbs.yuv")  # overlay: optional

The text bitstream is written through ``bitstream.write_bitstream`` and the
binary container (format SOTPB1) through ``binstream.write_binary``, both
byte-identical to the JAX package's files.  After a ``package=False``
encode the text writer gets the array interchange (the per-frame tensors
copied to the host) and the container the coded interchange: one
``rle_pack`` over the clip's tensors where they lie (the CUDA kernel on a
card, its plain twin on the CPU) and one copy of the coded buffer
(``binstream.coded_frames_of``).  After a ``package=True`` encode both get
the list interchange, and the container's lists are coded on the host
(``native``).  ``decode_bitstream_binary`` hands the decoder the
container's lists as read (``binstream.CodedResiduals``), which the decoder
copies to its device in one piece and decodes there (``rle_unpack``).

``device`` defaults to ``"cuda"``; the CPU runs only when asked for
(``device="cpu"``).  With ``mesh=`` in place of ``device=``
(``parallel.make_mesh``), encode and
decode go through ``parallel.ShardedCodec``, GOP- and row-tile-sharded over
the mesh's devices, with the same package and streams::

    mesh = make_mesh(cfg, devices=["cuda:0"] * 6)   # or ["cpu"] * 8
    codec = VideoCodec(cfg, y_frames, mesh=mesh)

With ``cfg.engine == "compat"`` the facade runs ``compat_engine.CompatCodec``,
the engine bit-exact with the NumPy reference, on ``device``: the same
package keys and text bitstream, no mesh and no binary-container decode
(the JAX facade's refusals).

The mesh runs every tool set a device runs but the parallel modes: rate
control, scene-change promotion, two-pass and ROI maps included.  A mesh
decodes a stream whose GOPs are not the mesh's (a GOP opening off
``intra_dur``: another encoder's stream) on one device, a ``TorchCodec`` on
the mesh's first device, as the JAX facade takes its single-chip decoder
for them; a promoted stream keeps its GOP openers and stays on the mesh.
The choice is made from the stream's frame types before anything is
decoded.

ROI streams are self-describing: the readers adopt a stream's per-block
QP-offset header into ``cfg`` (``bitstream.read_bitstream``,
``binstream.read_binary``), and the decoders, which hold the map from their
construction, are rebuilt whenever the effective map changed.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from streamoptima_tpu_torch import binstream as BIN
from streamoptima_tpu_torch import bitstream as BS
from streamoptima_tpu_torch import metrics, viz
from streamoptima_tpu_torch.compat_engine import CompatCodec
from streamoptima_tpu_torch.config import CodecConfig
from streamoptima_tpu_torch.io.video import VideoManager
from streamoptima_tpu_torch.engine import TorchCodec, frame_arrays_of
from streamoptima_tpu_torch.parallel import ShardedCodec
from streamoptima_tpu_torch.profiling import to_host, traced, tracer


class VideoCodec:
    """Encode/decode facade over ``TorchCodec`` (or, for ``engine="compat"``,
    ``CompatCodec``) on one ``device``, or over ``ShardedCodec`` on a
    ``mesh``, with file-level APIs."""

    def __init__(self, cfg: CodecConfig, y_frames=None, *, device=None, mesh=None):
        if device is not None and mesh is not None:
            raise TypeError("VideoCodec runs on one device or on a mesh: give at most one of device= and mesh=")
        if mesh is None and device is None:
            device = "cuda"
        if cfg.compat and mesh is not None:
            raise ValueError("multi-device encoding requires engine='jax'")
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.devices[0, 0]
        #: the tracer's request id of this codec's construction, encode and writes
        self._request = tracer.new_request()
        with tracer.request(self._request):
            if mesh is not None:  # the mesh refuses what it does not run
                self._enc = ShardedCodec(cfg, mesh, y_frames) if y_frames is not None else None
                self._dec_mesh = self._enc or ShardedCodec(cfg, mesh)
            else:
                self._enc = self._engine(cfg, y_frames) if y_frames is not None else None
                self._dec_mesh = None
            self._dec = self._engine(cfg)
        self._pkg = None
        self._decoded = None

    def _engine(self, cfg: CodecConfig, y_frames=None):
        """The one-device engine of ``cfg`` on the codec's device."""
        return (CompatCodec if cfg.compat else TorchCodec)(cfg, y_frames, device=self.device)

    # ----------------------------------------------------------- encoding
    def encode(self, compute_ssim: bool = True, **kw) -> dict:
        """Encode the clip; returns the package dict (the JAX facade's keys:
        PSNR, MAE, sizes, reconstructions, plus SSIM and the encode wall time
        under pkg["timing"]["total_s"]).  SSIM is one batched call on the
        codec's device (a mesh's first), ``metrics.ssim_frames``, on the
        engine's ``source`` and its reconstructions on the device
        (``recon``); its wall time is pkg["timing"]["ssim_s"]."""
        if self._enc is None:
            raise ValueError("construct with y_frames to encode")
        t0 = time.perf_counter()
        with tracer.request(self._request):
            pkg = self._enc.encode(**kw)
        pkg.setdefault("timing", {})["total_s"] = time.perf_counter() - t0
        recon = self._enc.recon  # on the device; fetch="metrics" keeps none
        if compute_ssim and recon is not None:
            t0 = time.perf_counter()
            pkg["SSIM per frame"] = metrics.ssim_frames(self._enc.source[: len(recon)], recon, device=self.device)
            pkg["timing"]["ssim_s"] = time.perf_counter() - t0
        self._pkg = pkg
        return pkg

    @traced("codec.fetch")
    def _stream(self, coded: bool = False) -> tuple:
        """The last encode's (frame_types, mvs, qp_rows, residuals), for the
        writers: of a ``package=False`` encode the array interchange, or
        with ``coded`` the coded one (``binstream.coded_frames_of``, as both
        mvs and residuals); else the list interchange."""
        if self._pkg is None:
            raise ValueError("encode() first")
        p = self._pkg
        if "per_frame" in p and coded:
            mvs = res = BIN.coded_frames_of(p["per_frame"], p["frame_type_seq"], p["residual size per frame"])
        elif "per_frame" in p:
            pairs = [frame_arrays_of(o, ft) for o, ft in zip(p["per_frame"], p["frame_type_seq"])]
            mvs, res = [m for m, _ in pairs], [r for _, r in pairs]
        else:
            mvs, res = p["MVS per Frame"], p["approx residual"]
        return p["frame_type_seq"], mvs, p["Qp_per_row_per_frame"], res

    def transmit_bitstream(self, mv_file, residual_file, raw_mv_file=None) -> None:
        """Write the two text bitstream files of the last encode."""
        with tracer.request(self._request):
            fts, mvs, qps, res = self._stream()
            BS.write_bitstream(mv_file, residual_file, fts, mvs, qps, res, self.cfg, raw_mv_path=raw_mv_file)

    def transmit_bitstream_binary(self, path) -> None:
        """Write the last encode as the one-file binary container
        (``binstream``, format SOTPB1); a ``package=False`` encode's
        coefficients are coded where they lie, by ``rle_pack``."""
        with tracer.request(self._request):
            BIN.write_binary(path, *self._stream(coded=True), self.cfg)

    # ----------------------------------------------------------- decoding
    def decode(self, frame_types=None, residuals=None, qp_rows=None, mvs=None) -> np.ndarray:
        """In-memory decode; with no arguments, decodes the last encode's
        list-form package."""
        if frame_types is None:
            p = self._pkg
            if p is None or "approx residual" not in p:
                raise ValueError("encode() with packaging first")
            frame_types, residuals, qp_rows, mvs = (
                p["frame_type_seq"], p["approx residual"], p["Qp_per_row_per_frame"], p["MVS per Frame"])
        # a mesh shards GOP-regular streams; any other decodes on one device
        dec = self._dec_mesh if self._dec_mesh is not None and self._dec_mesh.gop_regular(frame_types) else self._dec
        with tracer.request():
            return self._finish(dec.decode(frame_types, residuals, qp_rows, mvs))

    def _read(self, read) -> tuple:
        """Run a bitstream reader and return ``decode``'s arguments
        (frame_types, residuals, qp_rows, mvs), on the host.  The readers
        adopt a stream's ROI map into ``cfg`` (or clear an adopted one); a
        stream that changes the effective map rebuilds the decoders
        (the JAX package's facade does the same)."""
        before = None if self.cfg.roi_qp_map is None else np.asarray(self.cfg.roi_qp_map)
        fts, mvs, qps, res = read()
        after = None if self.cfg.roi_qp_map is None else np.asarray(self.cfg.roi_qp_map)
        if (before is None) != (after is None) or (before is not None and not np.array_equal(before, after)):
            self._dec = self._engine(self.cfg)
            if self._dec_mesh is not None:
                self._dec_mesh = ShardedCodec(self.cfg, self.mesh)
        return fts, res, qps, mvs

    def parse_bitstream(self, mv_file, residual_file) -> tuple:
        """Parse the two text bitstream files into ``decode``'s arguments."""
        return self._read(lambda: BS.read_bitstream(mv_file, residual_file, self.cfg))

    def decode_bitstream(self, mv_file, residual_file) -> np.ndarray:
        """File-level decode of the two text bitstream files."""
        with tracer.request():
            return self.decode(*self.parse_bitstream(mv_file, residual_file))

    def decode_bitstream_binary(self, path) -> np.ndarray:
        """File-level decode of the binary container (the native engine's:
        the compat engine replicates the reference, which has none)."""
        if self.cfg.compat:
            raise ValueError("the binary container requires engine='jax'")
        with tracer.request():
            return self.decode(*self._read(lambda: BIN.read_binary(path, self.cfg)))

    @traced("codec.finish")
    def _finish(self, frames) -> np.ndarray:
        self._decoded = to_host(torch.stack(frames), "finish")
        return self._decoded

    def save_decoded_frames(self, path, overlay_path=None) -> None:
        """Write decoded Y frames as raw bytes; with ``overlay_path``, also
        the frames with each block's partition drawn in
        (``viz.vbs_overlay_frames``), which needs the list-form package
        (``encode()`` with ``package=True``)."""
        if self._decoded is None:
            raise ValueError("decode first")
        VideoManager.save_y_only(path, self._decoded)
        if overlay_path is not None:
            if self._pkg is None or "MVS per Frame" not in self._pkg:
                raise ValueError("the VBS overlay needs the list-form package: encode() with package=True first")
            VideoManager.save_y_only(overlay_path, viz.vbs_overlay_frames(
                self._decoded, self._pkg["MVS per Frame"], self._pkg["frame_type_seq"], self.cfg))

    def save_reconstructed(self, path) -> None:
        """Write the encoder-side reconstructions."""
        if self._pkg is None:
            raise ValueError("encode() first")
        VideoManager.save_y_only(path, self._pkg["reconstructed frames"])
