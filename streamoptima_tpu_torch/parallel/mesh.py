"""GOP- and row-tile-sharded encode and decode over a mesh of devices.

Counterpart of ``streamoptima_tpu.parallel.mesh`` for its full-search
configurations.  A ``Mesh`` lays devices out on two axes:

- "data": each row of the mesh codes whole GOPs.  Every GOP opens with an
  intra frame (``i % intra_dur == 0``), so GOPs are independent and sharding
  them is exact.
- "tile": each device of a row codes a horizontal band of block rows.  Intra
  mode 0 never reads outside its band, so intra frames need nothing from the
  neighbours.  Inter frames read ``search_range + 1`` halo rows of each
  neighbour's references (``_halo_band``), or with
  ``tile_comm="all_gather"`` the whole reference frames.  The search and
  fetch kernels take the band and evaluate every bound at frame rows
  (``core/kernels.py``), so the result is bit-identical to ``TorchCodec`` on
  one device.

Fast ME always reads whole reference frames: its MVP walk is not bounded by
the search range (mesh.py:613-617 of the JAX package).  The chain crosses
tiles: each pass launches ``rowscan_pass`` on every tile of the data row,
and a tile's first seed is the last MV of the tile above
(``motion.fast_chain``, shared with ``TorchCodec``).

A device may appear more than once: ``make_mesh(cfg, devices=[cuda0] * 6)``
runs a (2, 3) mesh on one card, as the JAX package's 8 virtual CPU devices
run its mesh on one host.  One host thread queues each shard's work on its
device in turn.

The mesh runs the full search and fast ME (whole-pel or half-pel, VBS on or
off, up to eight references) with intra mode 0, and intra mode 1 on the
"data" axis alone, with rate control: per-row QPs from the rate tables,
scene-change promotion (``rc_flag > 1``), clip-level two-pass and ROI maps.
A frame's row QPs are one (block_rows,) vector; each tile takes its rows
of it and turns them into block QPs with its own ROI rows
(``TorchCodec._frame_qps``), so the block QPs are the single device's.

Promotion: an inter frame runs on every tile first; where the merged
frame's size (the tiles' sizes summed) exceeds ``intra_thresh``, every tile
codes it again intra and empties its reference FIFO.  That is one size read
per inter frame, as on one device.  The JAX mesh batches the GOPs of its
data rows in one SPMD program and selects per GOP between the inter and the
intra result (``_select_gops``); here the host runs each GOP in turn on its
data row, so each GOP decides for itself and no select is needed.

Two-pass: pass 1 is the GOP loop at the table QPs, promotion decided there;
its merged row bits come to the host in one copy, ``rc.second_pass_row_qps``
gives every frame's row QPs, and pass 2 codes with pass 1's frame types and
those rows (``engine.encode_passes``, which ``TorchCodec.encode`` runs too).  The decode reads the stream's row QPs
and hands each tile its rows.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from streamoptima_tpu_torch import metrics
from streamoptima_tpu_torch.config import CodecConfig
from streamoptima_tpu_torch.core import motion as MO
from streamoptima_tpu_torch.engine import (PinnedStage, TorchCodec, build_package, encode_passes, fifo_push,
                                           pack_stream, promotes, unpack_payload, upload_stream)
from streamoptima_tpu_torch.profiling import to_device

#: per-frame outputs that concatenate over tiles, in block raster or row order
_TILED_KEYS = ("mv", "split", "sub_mv", "qtc_full", "qtc_quads", "row_bits", "recon", "mae")


def _halo_band(tiles: list, t: int, halo: int, device) -> torch.Tensor:
    """Tile ``t``'s (h_t + 2 * halo, w) band of one reference frame: its own
    rows with ``halo`` rows of each vertical neighbour's, copied to
    ``device``.  Edge tiles get zero rows, outside the frame (the JAX mesh's
    ppermute fill); every read of them is masked at frame rows.  ``tiles``:
    the frame's (h_t, w) tile on each tile's device."""
    own = tiles[t]
    zeros = own.new_zeros((halo, own.shape[1]))
    top = tiles[t - 1][-halo:].to(device) if t > 0 else zeros
    bottom = tiles[t + 1][:halo].to(device) if t + 1 < len(tiles) else zeros
    return torch.cat([top, own, bottom])


def _all_gather(tiles: list, device) -> torch.Tensor:
    """The whole frame from its tiles, on ``device``."""
    return torch.cat([x.to(device) for x in tiles])


class Mesh:
    """A (data, tile) grid of torch devices: ``devices`` is a 2-D numpy
    object array, the role of ``jax.sharding.Mesh``."""

    axis_names = ("data", "tile")

    def __init__(self, devices):
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty (data, tile) grid of devices")
        self.devices = np.array(rows, dtype=object)


def make_mesh(cfg: CodecConfig, devices=None, tile: int | None = None) -> Mesh:
    """A ("data", "tile") mesh over ``devices`` (default: every visible CUDA
    device), factored as ``streamoptima_tpu.parallel.make_mesh`` does.

    ``tile`` must divide both the device count and the frame's block-row
    count, and the inter halo (search_range + 1 rows) must fit the per-tile
    band; by default the largest such divisor is chosen and the remaining
    devices go to GOP ("data") parallelism.  Intra mode 1 takes tile 1.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; list the devices (devices=['cpu'] * 8 runs "
                               "an 8-device mesh on the CPU)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    nbr = cfg.block_rows
    halo = cfg.search_range + 1

    def halo_fits(t: int) -> bool:
        return t == 1 or halo <= (nbr // t) * cfg.block_size

    if cfg.intra_mode == 1:
        # mode 1's column chain spans all row tiles; only GOP ("data") parallelism applies
        if tile not in (None, 1):
            raise ValueError("intra_mode=1 requires tile=1 (the vertical intra chain crosses row-tile boundaries)")
        tile = 1
    if tile is None:
        tile = next(d for d in range(n, 0, -1) if n % d == 0 and nbr % d == 0 and halo_fits(d))
    if n % tile or nbr % tile:
        raise ValueError(f"tile={tile} must divide device count {n} and block rows {nbr}")
    if not halo_fits(tile):
        raise ValueError(f"tile={tile} leaves {(nbr // tile) * cfg.block_size} pixel rows per band, smaller than "
                         f"the search halo {halo}; lower the tile count")
    return Mesh([devices[i * tile:(i + 1) * tile] for i in range(n // tile)])


def check_mesh_slice(cfg: CodecConfig) -> None:
    """Refuse, by name, what the mesh does not run (``ValueError``): the host
    reference engine and the reference's parallel modes, as the JAX mesh
    does."""
    if cfg.compat:
        raise ValueError("sharded encoding requires the native engine (engine='jax')")
    if cfg.parallel_mode != 0:
        raise ValueError("mesh sharding replaces the reference's parallel modes: parallel_mode must be 0")


class ShardedCodec:
    """GOP- and row-sharded encoder and decoder over a ``Mesh``.

    ``encode`` returns ``TorchCodec.encode``'s package, bit for bit (PSNR
    too: it is computed on each whole frame, on the mesh's first device,
    where the merged per-frame outputs live), but for "fast_me_passes":
    the mesh's own passes per inter frame, each pass one ``rowscan_pass``
    launch per tile.  ``decode`` shards the same way and returns the frames
    on that device.
    """

    def __init__(self, cfg: CodecConfig, mesh: Mesh, y_frames=None, tile_comm: str = "halo"):
        check_mesh_slice(cfg)
        self.ndata, self.ntile = mesh.devices.shape
        if cfg.intra_mode == 1 and self.ntile != 1:
            raise ValueError("intra_mode=1 shards the 'data' (GOP) axis only: the vertical intra chain crosses "
                             "row-tile boundaries (make_mesh forces tile=1)")
        if tile_comm not in ("halo", "all_gather"):
            raise ValueError(f"tile_comm must be 'halo' or 'all_gather', not {tile_comm!r}")
        if cfg.block_rows % self.ntile:
            raise ValueError(f"{self.ntile} tiles do not divide {cfg.block_rows} block rows")
        self.cfg, self.mesh, self.tile_comm = cfg, mesh, tile_comm
        self.y = None if y_frames is None else np.asarray(y_frames, dtype=np.uint8)
        self.gl = cfg.intra_dur  # GOP length
        self.nbr_t = cfg.block_rows // self.ntile
        self.nb_t = self.nbr_t * cfg.blocks_per_row
        self.h_t = self.nbr_t * cfg.block_size
        self.halo = cfg.search_range + 1
        if self.ntile > 1 and tile_comm == "halo" and self.halo > self.h_t:
            raise ValueError(f"the search halo {self.halo} exceeds the {self.h_t}-row tile; lower the tile count")
        self.home = mesh.devices[0, 0]
        self._stage = PinnedStage()  # the decode's staging of a container's coded lists, for home
        # one engine per shard: its device and its tile's rows
        self._tiles = [[TorchCodec(cfg, device=mesh.devices[d, t], rows=(t * self.h_t, (t + 1) * self.h_t))
                        for t in range(self.ntile)] for d in range(self.ndata)]
        self._frames_dev = None  # per shard: its GOPs' frames, its tile's rows (staged at the first encode)
        self.fast = cfg.fast_me
        #: fast ME: the passes of each inter frame of the last encode, in frame order
        self.fast_me_passes: list[int] = []
        self._g_carry: list = []  # fast ME, per data row: its last inter frame's MVPs per tile
        #: the last encode's reconstructions, (n, h, w) uint8 on the first device (None before an encode or
        #: after one with fetch="metrics")
        self.recon: torch.Tensor | None = None
        #: the frame's per-row QPs of each frame type (the rate tables' or qp), on the host
        self.row_qps_np = self._tiles[0][0].row_qps_np

    @property
    def source(self) -> np.ndarray | None:
        """The clip the metrics compare against: the host array (each shard
        holds only its part on its device)."""
        return self.y

    # ----------------------------------------------------------- shared
    def _bands(self, fifos: list, d: int, t: int, comm: str) -> tuple[list, int]:
        """Tile ``t``'s reference bands on data row ``d`` and the band row of
        its row 0.  ``fifos``: each tile's reference FIFO."""
        dev = self.mesh.devices[d, t]
        if self.ntile == 1 or comm == "all_gather":
            return [_all_gather([f[r] for f in fifos], dev) for r in range(len(fifos[t]))], t * self.h_t
        return [_halo_band([f[r] for f in fifos], t, self.halo, dev) for r in range(len(fifos[t]))], self.halo

    def _tile_rows(self, rows: torch.Tensor, d: int, frames: range) -> list:
        """Each tile's block rows of ``frames``' row QPs (an (n, block_rows)
        tensor on the first device), on its device on data row ``d``: views
        where it is the first device, else one copy per tile."""
        sl = slice(frames[0], frames[-1] + 1)
        return [rows[sl, t * self.nbr_t:(t + 1) * self.nbr_t].to(dev) for t, dev in enumerate(self.mesh.devices[d])]

    def _size(self, outs: list) -> torch.Tensor:
        """One frame's size: its tiles' sizes summed, on the first device."""
        return torch.stack([o["size"].to(self.home) for o in outs]).sum()

    def _merge(self, outs: list, curs: list) -> dict:
        """One frame's tile outputs as one frame's output on the first device:
        block rasters and rows concatenated in tile order, sizes summed, PSNR
        on the whole frame."""
        m = {k: torch.cat([o[k].to(self.home) for o in outs]) for k in _TILED_KEYS}
        m["size"] = self._size(outs)
        m["psnr"] = metrics.psnr(_all_gather(curs, self.home), m["recon"])
        return m

    # ------------------------------------------------------------ encode
    def _stage_frames(self) -> None:
        """Upload each shard's part of the clip once: the frames of the GOPs
        its data row codes, the rows of its tile."""
        n, gl = self.cfg.frames, self.gl
        self._frames_dev = [[None] * self.ntile for _ in range(self.ndata)]
        for d in range(self.ndata):
            idx = [i for i in range(n) if (i // gl) % self.ndata == d]
            for t in range(self.ntile):
                part = np.ascontiguousarray(self.y[idx, t * self.h_t:(t + 1) * self.h_t])
                self._frames_dev[d][t] = to_device(part, self.mesh.devices[d, t], "clip")

    def _inter_tiles(self, d: int, curs: list, fifos: list, qps: list) -> list:
        """One inter frame on data row ``d``: each tile's step against its
        reference bands at its block QPs ``qps``.  Fast ME reads whole frames
        and solves the frame's chain over the row's tiles first
        (``fast_chain``), warm-started from the row's last inter frame; each
        tile then confirms at its MVPs."""
        engines = self._tiles[d]
        comm = "all_gather" if self.fast else self.tile_comm
        refs = [self._bands(fifos, d, t, comm) for t in range(self.ntile)]
        planes = [e.motion.planes(bands) for e, (bands, _) in zip(engines, refs)]
        mvps = [None] * self.ntile
        if self.fast:
            mvps, passes = MO.fast_chain([e.motion for e in engines], curs, planes, self._g_carry[d])
            self.fast_me_passes.append(passes)
            self._g_carry[d] = mvps
        return [e._inter_step(c, p, band_row0=b0, qps=q, mvp=g)
                for e, c, p, (_, b0), q, g in zip(engines, curs, planes, refs, qps, mvps)]

    def _encode_gop_local(self, d: int, frames: range, ftypes_fixed: list | None = None,
                          rqps: torch.Tensor | None = None, light: bool = False) -> tuple[list, list]:
        """Encode one GOP on data row ``d``: the intra frame, then each inter
        frame against the tiles' reference FIFOs.  Under promotion an inter
        frame whose merged size exceeds ``intra_thresh`` is coded again intra
        on every tile, and the FIFOs start over from it.  ``ftypes_fixed`` /
        ``rqps``: two-pass's second pass, with pass 1's frame types and the
        clip's (n, block_rows) row QPs on the first device.  ``light`` keeps
        only each frame's row bits (pass 1).  Returns the merged per-frame
        outputs and the frame types."""
        cfg, engines, gl = self.cfg, self._tiles[d], self.gl
        promote = promotes(cfg, ftypes_fixed)
        rows = None if rqps is None else self._tile_rows(rqps, d, frames)

        def qps(k: int, ftype: int) -> list:  # each tile's block QPs of the GOP's frame k
            if rows is None:
                return [e.qps_by_type[ftype] for e in engines]
            return [e._frame_qps(r[k], ftype) for e, r in zip(engines, rows)]

        fifos = [[] for _ in engines]
        outs, ftypes = [], []
        for k, i in enumerate(frames):
            pos = i // gl // self.ndata * gl + k  # frame i among its data row's staged frames
            curs = [self._frames_dev[d][t][pos] for t in range(self.ntile)]
            intra = k == 0 if ftypes_fixed is None else ftypes_fixed[i] == 0
            if intra:
                tile_outs, ftype = [e._intra_step(c, q) for e, c, q in zip(engines, curs, qps(k, 0))], 0
            else:
                tile_outs, ftype = self._inter_tiles(d, curs, fifos, qps(k, 1)), 1
                # scene-change promotion: one size read per inter frame, as on one device
                if promote and int(self._size(tile_outs)) > cfg.intra_thresh:
                    tile_outs, ftype = [e._intra_step(c, q) for e, c, q in zip(engines, curs, qps(k, 0))], 0
            ftypes.append(ftype)
            if light:
                outs.append({"row_bits": torch.cat([o["row_bits"].to(self.home) for o in tile_outs])})
            else:
                outs.append(self._merge(tile_outs, curs))
            for fifo, o in zip(fifos, tile_outs):  # after every tile's step: the halos are the last frame's
                if ftype == 0:
                    fifo.clear()
                fifo_push(fifo, o["recon"], cfg.n_ref_frames)
        return outs, ftypes

    def _run_scan_batches(self, ftypes_fixed: list | None = None, rqps: np.ndarray | None = None,
                          light: bool = False) -> tuple[list, list]:
        """Every GOP's merged per-frame outputs and frame types: GOPs in
        batches of ``ndata``, GOP g on data row g % ndata (arguments: those
        of ``_encode_gop_local``, but ``rqps`` on the host, uploaded here in
        one copy).  The last batch and the last GOP run only
        their real frames: the JAX mesh pads them with the last frame to keep
        its compiled shapes and drops the padding's outputs."""
        n, gl = self.cfg.frames, self.gl
        per_frame, ftypes = [], []
        self.fast_me_passes = []
        self._g_carry = [[None] * self.ntile for _ in range(self.ndata)]
        rqps = None if rqps is None else to_device(rqps, self.home, "row_qps")
        for g in range(math.ceil(n / gl)):
            outs, types = self._encode_gop_local(g % self.ndata, range(g * gl, min(n, (g + 1) * gl)), ftypes_fixed,
                                                 rqps, light)
            per_frame += outs
            ftypes += types
        return per_frame, ftypes

    def encode(self, package: bool = True, fetch: str = "full") -> dict:
        """Full-clip encode: ``TorchCodec.encode``'s package.  ``fetch``:
        "full" (the list interchange, or with ``package=False`` the device
        tensors under "per_frame"), "light" (neither) or "metrics" (no
        reconstructions either).  Two-pass is clip-level
        (``engine.encode_passes``), over the GOP loop."""
        if self.y is None:
            raise ValueError("construct with y_frames to encode")
        if self._frames_dev is None:
            self._stage_frames()
        cfg = self.cfg
        per_frame, ftypes, qp_rows = encode_passes(cfg, self.row_qps_np, self._run_scan_batches)
        pkg, self.recon = build_package(cfg, per_frame, ftypes, "arrays" if fetch == "full" and not package else fetch,
                                        qp_rows)
        if self.fast:
            pkg["fast_me_passes"] = list(self.fast_me_passes)
        return pkg

    # ------------------------------------------------------------ decode
    def _decode_comm(self, mv_all: np.ndarray, smv_all: np.ndarray) -> str:
        """The tile communication a stream needs.  The halo serves vertical
        MVs up to the search range (twice it on the half-pel grid); a stream
        with longer ones (another encoder's fast-ME chain) decodes from whole
        frames."""
        if self.ntile == 1 or self.tile_comm == "all_gather":
            return self.tile_comm
        bound = self.cfg.search_range * (2 if self.cfg.fme_enable else 1)
        max_dy = max(int(np.abs(mv_all[..., 1]).max(initial=0)), int(np.abs(smv_all[..., 1]).max(initial=0)))
        return "all_gather" if max_dy > bound else "halo"

    def _decode_gop_local(self, d: int, frames: range, frame_types, stream: tuple, rqp_all, comm: str) -> list:
        """Decode one GOP on data row ``d``; frame-type driven, so an intra
        frame inside the GOP resets the FIFOs as ``TorchCodec.decode`` does.
        ``stream``, ``rqp_all``: ``upload_stream``'s tensors (the row QPs
        None without rate control: the table QPs)."""
        engines = self._tiles[d]
        vbs = self.cfg.vbs_enable
        sl = slice(frames[0], frames[-1] + 1)
        shards = []  # per tile: its blocks of the GOP's arrays, views where its device is the first, else a copy
        for t, e in enumerate(engines):
            blocks = slice(t * self.nb_t, (t + 1) * self.nb_t)
            shards.append([None if a is None else a[sl, blocks].to(e.device) for a in stream])
        rows = None if rqp_all is None else self._tile_rows(rqp_all, d, frames)
        fifos = [[] for _ in engines]
        out = []
        for k, i in enumerate(frames):
            intra = int(frame_types[i]) == 0
            tiles = []
            for t, e in enumerate(engines):
                mv, smv, split, pay = (None if a is None else a[k] for a in shards[t])
                qf, qq = unpack_payload(split, pay, vbs)
                qps = None if rows is None else e._frame_qps(rows[t][k], 0 if intra else 1)
                if intra:
                    f = e._recon_intra(mv[:, 0], split, smv[:, :, 0] if vbs else None, qf, qq, qps)
                else:
                    bands, band_row0 = self._bands(fifos, d, t, comm)
                    pf, pq = e.motion.fetch(mv, smv, e.motion.planes(bands), band_row0)
                    f = e._recon_inter(pf, pq, split, qf, qq, qps)
                tiles.append(f)
            for fifo, f in zip(fifos, tiles):
                if intra:
                    fifo.clear()
                fifo_push(fifo, f, self.cfg.n_ref_frames)
            out.append(_all_gather(tiles, self.home))
        return out

    def gop_regular(self, frame_types) -> bool:
        """Whether a stream's GOPs are the mesh's: every frame i with
        i % intra_dur == 0 intra.  Only such a stream shards over the "data"
        axis; one whose GOPs open elsewhere (another intra_dur) decodes on
        one device.  Intra frames inside a GOP (scene-change promotion) keep
        a stream regular: they reset the tiles' FIFOs."""
        return all(int(ft) == 0 for ft in frame_types[::self.gl])

    def decode(self, frame_types, residuals_per_frame, qp_rows_per_frame, mvs_per_frame) -> list:
        """Sharded decode of list- or array-form interchange (the bitstream
        readers' output) into a list of (h, w) uint8 tensors on the mesh's
        first device, where the stream is uploaded once.  Every GOP must open intra (``gop_regular``): the
        "data" axis relies on GOP independence."""
        gl = self.gl
        if not self.gop_regular(frame_types):
            i = next(i for i in range(0, len(frame_types), gl) if int(frame_types[i]) != 0)
            raise ValueError(f"frame {i} has type {frame_types[i]} but every GOP must open intra "
                             "(i % intra_dur == 0): the sharded decoder relies on GOP independence")
        cfg = self.cfg
        packed = pack_stream(cfg, frame_types, residuals_per_frame, mvs_per_frame, qp_rows_per_frame)
        comm = self._decode_comm(packed[0], packed[1])
        d_mv, d_smv, d_split, d_pay, d_rqp = upload_stream(packed, self.home, cfg.vbs_enable, cfg.rc_active,
                                                           self._stage)
        n = len(frame_types)
        out = []
        for g in range(math.ceil(n / gl)):
            out += self._decode_gop_local(g % self.ndata, range(g * gl, min(n, (g + 1) * gl)), frame_types,
                                          (d_mv, d_smv, d_split, d_pay), d_rqp, comm)
        return out
