"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``streamoptima_tpu_torch/csrc``, holds
each kernel, in each of its modes, against its plain PyTorch version on the
card at the 720p shapes, then drives the paths below through the
``VideoCodec`` facade, each encode -> text bitstream -> decode, bit-exact,
with every inter frame going through the path's kernels, every intra
frame's reconstruction through ``intra_recon`` (one launch per intra frame
and tile in each encode pass and each decode), and each kernel's launch
count equal to what the path must make (every other kernel: none).
All are 720p, bs=16, qp=4, intra_dur=8, lam=0.015 on
``synthetic_clip(720, 1280, 16)``:

- ``[main]``: the config ``bench.py`` runs (720p IPPP, sr=8, one reference,
  whole-pel full search), 16 frames;
- ``[main-vbs-fme]``: the same with variable block size and half-pel FME
  (``benchmarks/sweep.py``'s ``720p_vbs_fme``), 16 frames;
- ``[main-fast-vbs-fme]``: fast ME with VBS and FME at sr=16
  (``sweep.py``'s ``720p_fast_me_vbs_fme``, the JAX package's default tool
  set), 16 frames: every inter frame solves its MVP chain with the
  ``rowscan_pass`` kernel and confirms through ``window_fetch`` and one
  ``fast_confirm`` launch;
- ``[main-fast]``: fast ME whole-pel, no VBS (``720p_fast_me``), 16 frames;
- ``[main-vbs]``: ``720p_vbs_fme`` without FME: whole-pel VBS full search,
  16 frames;
- ``[main-nref4]``: ``sweep.py``'s ``720p_nref4``, whole-pel full search over
  up to four reference frames, 16 frames;
- 8 frames each: ``[main-fme]`` (FME alone, sr=8), ``[main-fast-vbs]`` and
  ``[main-fast-fme]`` (fast ME with one of the two, sr=16), ``[main-intra1]``
  (intra mode 1, VBS, sr=16), ``[main-pm1]``, ``[main-pm2]`` (fast ME, sr=16)
  and ``[main-pm3]`` (the three parallel modes).

The mesh (``streamoptima_tpu_torch.parallel``) runs on six shards of the one
card, ``make_mesh(cfg, devices=[cuda:0] * 6)``: data 2 x tile 3, each tile
240 rows with ``search_range + 1`` halo rows of its neighbours.  Six shards
on one card measure correctness and the host's cost, not scaling.

- ``[mesh]``: ``[main]``'s config, 16 frames; ``[mesh-vbs-fme]``:
  ``[main-vbs-fme]``'s, 16 frames; ``[mesh-vbs]`` and ``[mesh-fme]``: VBS or
  FME alone, 8 frames.  Each, besides ``_drive``'s checks, must equal the
  single-device encode bit for bit (MVs, coefficients, sizes, PSNR,
  reconstructions, text bitstream bytes) and the ``tile_comm="all_gather"``
  encode; every launch of its search and fetch is a band launch, three per
  inter frame.

- ``[mesh-fast-vbs-fme]``: ``[main-fast-vbs-fme]``'s config, 16 frames, and
  ``[mesh-fast]``: whole-pel fast ME, 8 frames.  Fast ME reads whole
  reference frames; each pass of a frame's chain launches ``rowscan_pass``
  once per tile, so its launches are three times the mesh's recorded
  passes, and ``window_fetch`` and ``fast_confirm`` three each per inter
  frame.

Rate control on the device, 8 frames each, at ``benchmarks/sweep.py``'s
settings (``rc_tables``, 8 mbps, 30 fps: the tables' QPs 7 and 8):

- ``[main-rc]``: ``720p_rc_row_qp`` (per-row QPs, one search per inter frame);
- ``[main-two-pass]``: ``720p_two_pass``, two encode passes, so two searches
  per inter frame;
- ``[main-roi]``: ``[main]`` with an ROI map of -2 on the centre third of
  the blocks (rows and columns) and +2 elsewhere;
- ``[main-rc-promote]``: ``rc_flag=2`` on the clip with a scene cut at frame
  4 (``synthetic_clip`` of seed 7, unsmoothed, from there), ``intra_thresh``
  twice the largest inter frame of ``[main-rc]`` in the same run: frame 4
  must be promoted to intra, and so are frames 5-7, which predict the noise
  from frame 4's coarse reconstruction (a promoted frame's search runs, its
  fetch does not).

Rate control on the mesh, the same configs on the six shards (each tile
codes its rows of every frame's QPs), each checked as the mesh paths above
(the single-device encode, frame types and row QPs included, and the
all-gather mesh):

- ``[mesh-rc]``: ``[main-rc]``'s config, 16 frames: both data rows code a
  GOP, and rate control crosses the GOP boundary;
- ``[mesh-two-pass]`` and ``[mesh-roi]``: ``[main-two-pass]``'s and
  ``[main-roi]``'s, 8 frames (two-pass: six band searches per inter frame);
- ``[mesh-rc-promote]``: ``[main-rc-promote]``'s config and threshold, 16
  frames: its clip's first 8 frames, the cut at frame 4 included, then the
  clip's own frames 8-15; frames 4-7 come out intra, the second GOP as
  ``[mesh-rc]``'s.

``[binary]`` writes the binary container (SOTPB1) from ``[main]``'s and
``[mesh]``'s encodes (one config, one device and the mesh) and from
``[mesh-rc]``'s and its single-device twin's: each pair of files is
byte-equal, and each file decodes on one device and on the mesh to the
reconstructions.  Each write codes the coefficients on the card: two
``rle_pack`` launches; each decode decodes them on the card: one
``rle_unpack`` launch.  ``[rle-pack]`` (after ``[main-fast-vbs-fme]``)
holds that kernel to its plain version on that path's 16 frames, the
encode cell's shapes, with every block split, with none, and at a short
capacity, and times it beside its plain version and its byte bound.
``[rle-unpack]`` holds the decode's kernel to its plain version and to the
host route's payload on that path's container (the decode cell's shapes),
and times it beside its byte bound, its plain version and the host RLE it
replaces (``native``).  ``[dryrun]`` runs ``parallel.dryrun.dryrun_multichip(8)`` on an
8-shard mesh of the card: the six feature sets of the JAX package's
multi-chip dry run at 64x64, each bit for bit with one device and its
sharded decode closed, with the launches each makes.

After them, three phases run the last modules on the card.  ``[ssim]``
holds ``metrics.ssim_frames`` (one batched call on the card) against the
host ``metrics.ssim``, frame by frame, on ``[main]``'s 16 sources and
reconstructions, within 1e-6, and prints both times; every path line also
prints the facade's SSIM seconds, on the device.  ``[cli]`` runs the command
line in this process (``main.main``), each run's launches counted.  Run A:
``[main]``'s config on a 4:2:0 file of the clip with seeded chroma and the
binary container, whose reconstruction file must be ``[main]``'s
reconstructions byte for byte and whose launches must be ``[main]``'s
encode's and one decode's fetches for each of its two decodes.  Run B: the
command line's defaults (CIF, 21 frames, fast ME + VBS + FME, sr 16) with
rate control measured on the card, two-pass and the VBS overlay, whose
launches must be those of its fast-ME steps and decodes, every file it
writes byte-equal to the same arguments' ``--device cpu`` run (the plain
versions), and whose overlay must hold the clip with its block grid drawn.
Run C, ``python3 -m streamoptima_tpu_torch --synthetic --frames 2`` in a
process of its own, covers the module's entry point.  Each must exit 0 with
its decoded file equal to its reconstruction file.  ``[profiling]`` prints
``profiling.time_steps``' table for ``[main]``'s config.

The reference-exact engine (``engine="compat"``, ``CompatCodec``) runs
after ``[cli]``, at CIF (its limit): ``[compat]``, the command line's
defaults with ``--engine compat`` (21 frames, fast ME + VBS + FME, sr 16,
qp 5) in this process; ``[compat-vbs-fme]``, the same with ``--frames 8
--no-fast-me`` (full search with VBS + FME, the fetch at the quads' own
FME margin for the residual and at the parent's, K18, for the
reconstruction and decode); ``[compat-rc-promote]``, through the facade, 8
whole-pel frames at ``rc_flag=2`` on a clip cut to noise at frame 4.  Each
writes its MV file, residual file and decoded YUV byte for byte as its
``--device cpu`` run does, decodes to its reconstructions, and launches
exactly its kernels (``dct_scipy`` four times a frame in encode, twice in
decode, under VBS).  The kernel phase's ``[dct-scipy]`` holds the
``dct_scipy`` kernel to its plain version on the card and both to
``scipy.fftpack`` on the host, on 10^6 blocks of each size and direction,
half of them half-integer DC ties; ``[intra-recon]`` holds the
``intra_recon`` kernel (mode-0 intra reconstruction, one launch a frame) to
its plain version on the card on the first intra frames of
``[main-fast-vbs-fme]`` and ``[main]``, on random residuals, splits and
MVs (out-of-range ones too) at sr 8 and 16, on intra mode 1's transposed
call and on a 240-row tile, and times it on the two real frames, the
mode-1 call and the tile.  ``[transform-select]``, ``[residual-recon]`` and
``[intra-search]`` hold the three residual-coding kernels to their plain
versions on the card on the arguments that ``[main]``'s,
``[main-fast-vbs-fme]``'s and ``[main-intra1]``'s intra and inter steps pass
them (read off the wrappers while the steps run; the fast path's inter call
also as decode makes it, int16) and on extremes (±255 checkerboards, zero
blocks and blocks without a valid candidate at QPs 0, 4 and 11; flat,
checkerboard and noise frames in both intra modes and on a wider canvas),
and time each; ``[profiling]`` ends with
``profile_main_path.profile_compat`` (``[compat]``'s encode and decode,
timed and profiled).

Before the paths, the band phase holds each search and fetch mode on the
three tiles' halo bands (sr = 8, zero rows past the frame's edges) against
its plain version, and times the three launches of one frame; the tile
phase holds ``rowscan_pass`` on each tile's rows with the whole frame's
planes (both modes; clip, black-vs-white, flat and drift inputs; zero,
random and converged seeds) and ``window_fetch`` at each tile's confirm origins against
their plain versions, and times each tile's launch.  ``[reference]`` also
holds rate control, promotion, two-pass and an ROI map, and fast ME on a
(2, 2) mesh of the card, against the CPU port.

Should the run outgrow its time, the 16-frame full-search paths are the ones
to cut to 8 frames first.

The kernel phase's inputs are the clip's frames 1 and 0, black against
white, a flat all-tie pair, and a zero block against a ramp on which every
fast-ME step drifts one step toward the bottom-right (so ``rowscan_pass``'s
prefetched regions cross every plane edge); ``rowscan_pass`` also starts
from seeds far outside the frame.

Every comparison is exact (tolerance 0): the codec's arithmetic is integer.
Prints one line per phase, then the kernels' JSON line, the card's name and
power limit, and as the last line ``{"ok": true, "device": {...}}``.  Any
failed phase raises, so the exit code is non-zero and no result is printed;
without a CUDA card it fails at once.

Each kernel's ``bound_ms`` is the least time the card could take for the
same work: the larger of the bytes it must move over the memory rate
(3.35 TB/s, the H100 SXM data sheet) and its operations over the integer
rate (SMs x 64 INT32 lanes x the maximum SM clock ``nvidia-smi`` reports),
counting one operation per pixel abs-diff-accumulate of each candidate the
inputs make valid; ``dct_scipy``'s operations are its float64 adds and
multiplies (counted by running the plain version's line on a counting
scalar) over SMs x 64 FP64 lanes x the same clock.  ``window_fetch``'s and
the whole-pel ``pred_fetch`` modes' ``library_ms`` is one PyTorch indexing
read of the zero-padded planes (references), which are padded and indexed
before the timing as the TPU kernel's ``window_prep`` pads once a frame (the
plain versions pad on every call); no single PyTorch call computes any of
the other functions (none reproduces scipy's rounding), and theirs is null.
``intra_recon``'s row is ``[main-fast-vbs-fme]``'s first intra frame (sr
16, VBS) with its launches on that path; ``[main]``'s (sr 8, no VBS), the
mode-1 call and the tile are under ``sr8_*``, ``intra1_*`` and ``tile_*``
keys; each mode's bound is its bytes (int32 residuals, MVs, flags and
sub-MVs read once, the uint8 frame written once), and ``step_us`` and
``bound_step_us`` divide the time and the bound by the column steps of its
chain.  The three residual-coding rows are ``[main-fast-vbs-fme]``'s (sr 16, VBS)
with their launches on that path: ``transform_select`` its inter step's
call (``intra_*``: its intra step's, ``main_*``: ``[main]``'s inter step,
``intra1_*``: ``[main-intra1]``'s intra step), ``residual_recon`` its decode
call (``encode_*``: the inter step's, ``intra_*``: the intra step's,
``main_*``: ``[main]``'s inter step), ``intra_search`` its intra frame
(``sr8_*``: ``[main]``'s, ``intra1_*``: mode 1's).  Their bounds are the
larger of the bytes (inputs read once, outputs written once; the recon's
inter call reads the variant each block uses) and the integer operations
(the transforms' multiply-adds, the search's abs-diffs of the sr + 1
distinct shifts) over the integer rate; their library time is null (no
PyTorch call computes these functions).
``dct_scipy``'s row (CIF's (396, 16, 16) forward) carries the inverse and
the 8 x 8 quads' numbers under ``inverse_*``, ``n8_*`` and ``n8_inverse_*``
keys, and ``pred_fetch_fme_vbs``'s the compat engine's K18 mode under
``k18_*`` keys (its launches: the wrapper's count of launches at a
non-default quad margin in ``[compat]``; its bytes: the quads read at that
margin).  The ``window_fetch`` row also carries the
confirm at four references under FME, (3600, 16, 18, 18), under ``nref4_*``
keys, and an odd-width input whose base is one byte past 16-byte alignment
under ``unaligned_*`` keys (each with its own bound, counted as the row's); its rows' ``write_floor_ms`` is one ``zero_`` of
an output-sized tensor, the launch and a bare write of the same bytes.
The two fast-ME rows carry the whole-pel mode's numbers under
``whole_pel_*`` keys beside the FME mode's; the two whole-pel search rows
and ``pred_fetch`` carry their numbers at four references (``[main-nref4]``)
under ``nref4_*`` keys, and ``full_search_vbs`` its numbers at sr=16
(``[main-intra1]``: 33^2 candidates, 297 groups of four for a macroblock's 32 lanes)
under ``sr16_*`` keys.  The ``fast_confirm`` row is the confirm of
``[main-fast-vbs-fme]``'s converged MVPs on the clip (FME, VBS, one
reference: (3600, 4, 18, 18) regions), with the whole-pel confirm of
``[main-fast]``'s (no VBS) under ``whole_pel_*`` keys; each is held to its
plain version (``core.fastme.confirm``) on those MVPs and on random MVPs of
either sign, some far outside the frame, on the clip, black-vs-white, flat
and drift inputs; its bound is bytes (the regions, the int32 pixels, MVPs
and origins read once, the winners written once) or the abs-diffs of every
window's pixels, whichever is larger.  The eight band modes are rows of their own
(``"<kernel> band"``): time, plain time and bound per launch (the mean over
the three tiles; ``frame_ms`` is one frame's three launches), launches on
the mesh paths.  The tile rows (``"rowscan_pass tile"`` and
``"window_fetch tile"``, the FME mode's numbers with the whole-pel mode's
under ``whole_pel_*`` keys) are per launch on a tile (the mean of three;
``frame_ms``: a mesh pass's three launches), with the launches of
``[mesh-fast-vbs-fme]`` and ``[mesh-fast]``; their bound counts the tile's
rows of cur, the plane bytes its windows read at the converged chain, and
the candidates its K7 bounds make valid there.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from streamoptima_tpu_torch import CodecConfig, _build, metrics, native, profiling, synthetic_clip
from streamoptima_tpu_torch import binstream as BIN
from streamoptima_tpu_torch import bitstream as BS
from streamoptima_tpu_torch.core import motion as MO
from streamoptima_tpu_torch.compat_engine import CompatCodec
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.core import fastme as FM
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.core import me as M
from streamoptima_tpu_torch.core import transform as T
from streamoptima_tpu_torch.core.blocks import blockify
from streamoptima_tpu_torch.core.pred import gather_predictions
from streamoptima_tpu_torch.engine import TorchCodec, frame_arrays_of, pack_stream
from streamoptima_tpu_torch.main import main as cli_main
from streamoptima_tpu_torch.parallel import ShardedCodec, make_mesh
from streamoptima_tpu_torch.parallel.dryrun import dryrun_multichip
from streamoptima_tpu_torch.parallel.mesh import _halo_band
from streamoptima_tpu_torch.profile_main_path import profile_compat

H, W, FRAMES = 720, 1280, 16
BS_, SR, QP, INTRA_DUR = 16, 8, 4, 8
N_INTER = FRAMES - FRAMES // INTRA_DUR
MIN_PSNR = 30.0  # qp=4 on the smooth synthetic clip sits near 35 dB
# the rate-controlled paths code at the table's QPs 7 and 8 (near 25-26 dB), the ROI path most blocks at QP 6;
# [main-rc-promote]'s last four frames are noise at QPs 7 and 8 (near 10-11 dB)
RC_MIN_PSNR, ROI_MIN_PSNR, PROMOTE_MIN_PSNR = 20.0, 24.0, 15.0
HBM_BYTES_PER_MS = 3.35e12 / 1e3
INT32_LANES_PER_SM = 64
VBS_FME = {"vbs_enable": True, "fme_enable": True}
FAST = {"fast_me": True, "search_range": 16}
FAST_VBS_FME = {**FAST, **VBS_FME}
#: the tool matrix beyond the four paths above, as the 720p paths run it
TOOLS = {
    "main-vbs": {"vbs_enable": True},
    "main-nref4": {"n_ref_frames": 4},
    "main-fme": {"fme_enable": True},
    "main-fast-vbs": {**FAST, "vbs_enable": True},
    "main-fast-fme": {**FAST, "fme_enable": True},
    "main-intra1": {"intra_mode": 1, "vbs_enable": True, "search_range": 16},
    "main-pm1": {"parallel_mode": 1},
    "main-pm2": {**FAST, "parallel_mode": 2},
    "main-pm3": {"parallel_mode": 3},
}
#: every kernel wrapper, by name: each path's launch counts cover them all
KERNELS = {name: getattr(K, name) for name in (
    "full_search", "full_search_vbs", "full_search_fme", "full_search_fme_vbs", "pred_fetch", "pred_fetch_vbs",
    "pred_fetch_fme", "pred_fetch_fme_vbs", "rowscan_pass", "window_fetch", "fast_confirm", "dct_scipy",
    "intra_recon", "transform_select", "residual_recon", "intra_search", "rle_pack", "rle_unpack")}
#: the wrappers a frame step's residual coding calls, whose real arguments the kernel phase reads off a step
STEP_WRAPPERS = ("intra_search", "transform_select", "residual_recon", "intra_recon")
FP64_LANES_PER_SM = 64  # Hopper: one float64 add or multiply per lane and cycle (an FMA counts two in data sheets)
CIF_H, CIF_W, CIF_FRAMES = 288, 352, 21  # the command line's defaults, which the compat paths run
#: rate control as ``benchmarks/sweep.py:136-159`` runs it: ~5.9k bits a row at 8 mbps, 30 fps, 45 rows
RC_TABLES = [[2e5, 1.2e5, 8e4, 5e4, 3e4, 2e4, 1.2e4, 8e3, 5e3, 3e3, 2e3, 1.2e3]] * 2
RC = {"rc_flag": 1, "target_br": "8 mbps", "frame_rate": 30, "qp_rate_tables": RC_TABLES}
N_SHARDS, N_TILES = 6, 3  # make_mesh at 720p (45 block rows): data 2 x tile 3
#: the band modes: kernel -> (source, the TPU function's line, VBS, FME)
BAND_MODES = {
    "full_search": ("full_search.cu", 213, False, False), "full_search_vbs": ("full_search.cu", 213, True, False),
    "full_search_fme": ("full_search_fme.cu", 621, False, True),
    "full_search_fme_vbs": ("full_search_fme.cu", 621, True, True),
    "pred_fetch": ("pred_fetch.cu", 1020, False, False), "pred_fetch_vbs": ("pred_fetch.cu", 1020, True, False),
    "pred_fetch_fme": ("pred_fetch.cu", 1020, False, True), "pred_fetch_fme_vbs": ("pred_fetch.cu", 1020, True, True),
}


def _cfg(h=H, w=W, frames=FRAMES, **kw) -> CodecConfig:
    kw.setdefault("search_range", SR)
    return CodecConfig(height=h, width=w, frames=frames, block_size=BS_, qp=QP, intra_dur=INTRA_DUR, lam=0.015,
                       **kw)


def _time_ms(fn, reps: int, cycles_per_ms: float) -> tuple[float, float]:
    """Device time of one ``fn`` call, the mean over ``reps`` warm calls
    between CUDA events, and the host's time to enqueue one call.

    A small kernel finishes before the host has enqueued the next one, so
    events around a bare loop time the host.  A spin kernel queued first,
    longer than the host's whole loop, keeps the stream busy meanwhile: the
    calls then run back to back on the device between the events.  The spin
    covers four times the host's measured loop and 5 ms more: on a shared
    host one loop can run slower than the one measured, and events that
    outlast the spin would time the host again."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(cycles_per_ms * (4 * host_ms * reps + 5)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def _max_err(pairs) -> int:
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) for x, y in pairs)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def _bound(nbytes: float, ops: float, int_ops_per_ms: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_MS, ops / int_ops_per_ms
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _search_ops(h: int, w: int, nref: int, fme: bool, dev, vbs: bool = True, sr: int = SR, g_row0: int = 0,
                frame_h: int | None = None) -> int:
    """Abs-diff-accumulates the search kernels do on these inputs: every
    pixel of every candidate that is valid for the block (or, with VBS, for
    the block or one of its quads); for a tile, frame rows [g_row0, g_row0 +
    h) of a ``frame_h``-row frame."""
    bx, by = M.block_origins(h, w, BS_, dev)
    qx, qy = M.quad_origins(h, w, BS_, dev)
    by, qy = by + g_row0, qy + g_row0
    fh = h if frame_h is None else frame_h
    scale, gsr = (2, 2 * sr) if fme else (1, sr)
    H, W = (2 * fh - 1, 2 * w - 1) if fme else (fh, w)
    ok = M.candidate_valid_mask(scale * bx, scale * by, gsr, BS_, H, W, fme=fme)
    if vbs:
        vq = M.candidate_valid_mask(scale * qx.reshape(-1), scale * qy.reshape(-1), gsr, BS_ // 2, H, W, fme=fme)
        ok |= vq.reshape(vq.shape[0], vq.shape[1], -1, 4).any(dim=-1)
    return int(ok.sum()) * BS_ * BS_ * nref


def _zero_counts() -> None:
    """Every kernel's launch count, and the fetch's count at the compat
    engine's quad margin, to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
    K.pred_fetch_fme_vbs.margin_launches = 0


def _fetch_bytes_read(mv, refs, sub_mv=None, fme=False, band_row0=0, g_row0=0, grid=None,
                      quad_margin=None) -> int:
    """Distinct reference bytes the fetch reads for these MVs: the plain
    gather on a grid of byte indices (fills 0 and 128 lie below them); with
    a band, as the band fetch reads it; ``quad_margin``: the quads' FME
    margin, as the fetch's argument."""
    base = 1000
    idx = torch.arange(refs.numel(), device=refs.device, dtype=torch.int64).reshape(refs.shape) + base
    w = refs.shape[-1]
    h = mv.shape[0] // (w // BS_) * BS_
    fh = refs.shape[-2] if grid is None else grid[0]
    g = M.grid_of_planes(idx) if fme else idx
    scale = 2 if fme else 1
    band = {"grid_dims": (scale * fh - (scale - 1), scale * w - (scale - 1)),
            "origin_row": scale * (g_row0 - band_row0)}
    bx, by = M.block_origins(h, w, BS_, refs.device)
    got = [gather_predictions(mv, g, bx, by + g_row0, BS_, fme=fme, **band).reshape(-1)]
    if sub_mv is not None:
        qx, qy = M.quad_origins(h, w, BS_, refs.device)
        got.append(gather_predictions(sub_mv.reshape(-1, 3), g, qx.reshape(-1), qy.reshape(-1) + g_row0, BS_ // 2,
                                      fme=fme, fme_margin=quad_margin, **band).reshape(-1))
    got = torch.cat(got)
    return int(torch.unique(got[got >= base]).numel())


def _leaves(x, path: str = "") -> list:
    """A result's tensors (a tensor, or tuples and dicts of them, nested; None kept) with their paths."""
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _leaves(x[k], f"{path}.{k}")]
    if isinstance(x, (tuple, list)):
        return [leaf for i, v in enumerate(x) for leaf in _leaves(v, f"{path}[{i}]")]
    return [(path, x)]


def _check_equal(what: str, got, plain) -> int:
    """Require a kernel's result (a tensor, or tuples and dicts of them) to
    equal its plain version's; returns the largest absolute difference (0)."""
    torch.cuda.synchronize()
    a, b = _leaves(got), _leaves(plain)
    _require([p for p, _ in a] == [p for p, _ in b] and all((x is None) == (y is None) for (_, x), (_, y) in zip(a, b)),
             f"{what}: the outputs {[p for p, _ in a]} differ in structure from {[p for p, _ in b]}")
    pairs = [(x, y) for (_, x), (_, y) in zip(a, b) if x is not None]
    for x, y in pairs:
        _require(torch.equal(x, y), f"{what}: differs from the plain version")
    return _max_err(pairs)


def _kernel_row(name, source, replaces, launches, err, ms, plain_ms, nbytes, ops, int_ops_per_ms,
                library_ms=None) -> dict:
    bound_ms, bound_by = _bound(nbytes, ops, int_ops_per_ms)
    return {"name": name, "route": "cuda", "source": f"streamoptima_tpu_torch/csrc/{source}",
            "replaces": f"streamoptima_tpu/core/me_pallas.py:{replaces}", "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def _chain_ops(g, nref: int, fme: bool, dev, h: int = H, g_row0: int = 0) -> int:
    """Abs-diff-accumulates one pass needs at MVPs ``g``: every pixel of
    every candidate the K7 bounds make valid; for a tile, frame rows
    [g_row0, g_row0 + h)."""
    bx, by = M.block_origins(h, W, BS_, dev)
    by = by + g_row0
    scale, dims = (2, (2 * H - 1, 2 * W - 1)) if fme else (1, (H, W))
    return int(FM.cand_valid(g, scale * bx, scale * by, BS_, dims).sum()) * BS_ * BS_ * nref


def _window_bytes_read(flat, by0, bx0, nwin: int) -> int:
    """Distinct plane bytes these windows hold (the zero fill reads none)."""
    idx = torch.arange(1, flat.numel() + 1, device=flat.device, dtype=torch.int64).reshape(flat.shape)
    got = FM.window_fetch_plain(idx, by0, bx0, nwin).reshape(-1)
    return int(torch.unique(got[got > 0]).numel())


def _window_library(flat, by0, bx0, nwin: int):
    """One PyTorch call computing ``window_fetch``'s function, for its row's
    ``library_ms``: an indexing read of the zero-padded planes straight into
    the (nb, P, nwin, nwin) layout.  The padded planes and the index tensors
    are built here, before any timing, as the TPU kernel's ``window_prep`` is
    built once a frame; the returned call is what is timed."""
    P, h, w = flat.shape
    padded = torch.nn.functional.pad(flat, (nwin, nwin, nwin, nwin))
    ar = torch.arange(nwin, device=flat.device)
    ri = (by0.to(torch.int64).clamp(-nwin, h)[:, None] + nwin + ar)[:, None, :, None]
    ci = (bx0.to(torch.int64).clamp(-nwin, w)[:, None] + nwin + ar)[:, None, None, :]
    pi = torch.arange(P, device=flat.device)[None, :, None, None]
    return lambda: padded[pi, ri, ci]


def _hold_window(what: str, flat, sets: dict, timed: str, cyc: float) -> dict:
    """``window_fetch`` (bs + 2 square windows) on ``flat`` at each origin
    set (name -> (by0, bx0)) against its plain version and the library read,
    exactly; then the kernel's, the plain version's and the library read's
    times at the set ``timed``, and a yardstick: one ``zero_`` of an
    output-sized tensor (the launch and a bare write of the same bytes)."""
    n = BS_ + 2
    err = 0
    for name, (by0, bx0) in sets.items():
        got = K.window_fetch(flat, by0, bx0, n)
        err = max(err, _check_equal(f"window_fetch {what} {name}", got, K.window_fetch_plain(flat, by0, bx0, n)))
        _require(torch.equal(_window_library(flat, by0, bx0, n)(), got),
                 f"window_fetch {what} {name}: differs from the library read")
    by0, bx0 = sets[timed]
    ms, host = _time_ms(lambda: K.window_fetch(flat, by0, bx0, n), 200, cyc)
    plain_ms, _ = _time_ms(lambda: K.window_fetch_plain(flat, by0, bx0, n), 20, cyc)
    lib_ms, _ = _time_ms(_window_library(flat, by0, bx0, n), 200, cyc)
    blank = torch.empty((by0.shape[0], flat.shape[0], n, n), dtype=torch.uint8, device=flat.device)
    floor_ms, _ = _time_ms(blank.zero_, 200, cyc)
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "lib_ms": lib_ms, "host_ms": host, "floor_ms": floor_ms}


def _fetch_library(refs, mv, sub_mv=None):
    """One PyTorch call computing the whole-pel ``pred_fetch``'s function (with
    ``sub_mv``, ``pred_fetch_vbs``'s two planes), for its row's
    ``library_ms``: an advanced-indexing read of the zero-padded references
    at every output pixel's (reference, row, column).  The padded
    references and the index tensors are built here, before any timing, as
    ``_window_library``'s are; the returned call is what is timed.  It
    returns the pixels as uint8, the kernel int16."""
    nref, h, w = refs.shape
    mvs = [mv.to(torch.int64)] if sub_mv is None else [mv.to(torch.int64), sub_mv.to(torch.int64)]
    pad = max(int(m[..., :2].abs().max()) for m in mvs) + 1
    padded = torch.nn.functional.pad(refs, (pad, pad, pad, pad))
    nbr, nbc, s = h // BS_, w // BS_, BS_ // 2
    per_px = [mvs[0].reshape(nbr, nbc, 3).repeat_interleave(BS_, 0).repeat_interleave(BS_, 1)]
    if sub_mv is not None:  # quads in Z order -> the quad grid -> pixels
        q = mvs[1].reshape(nbr, nbc, 2, 2, 3).permute(0, 2, 1, 3, 4).reshape(2 * nbr, 2 * nbc, 3)
        per_px.append(q.repeat_interleave(s, 0).repeat_interleave(s, 1))
    m = torch.stack(per_px)  # (planes, h, w, 3)
    yy = torch.arange(h, device=refs.device)[:, None] + pad
    xx = torch.arange(w, device=refs.device)[None, :] + pad
    ri, yi, xi = m[..., 2], yy + m[..., 1], xx + m[..., 0]
    return lambda: padded[ri, yi, xi]


def _line_ops(n: int, inverse: bool) -> int:
    """Float64 adds, subtracts and multiplies of one length-n line of the
    scipy-exact transform, counted by running the plain version's line on a
    counting scalar (negations are sign flips and not counted)."""
    count = [0]

    class Op:
        def _op(self, other):
            count[0] += 1
            return self

        __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _op

        def __neg__(self):
            return self

    (T._dct3_line if inverse else T._dct2_line)([Op() for _ in range(n)], T.scipy_plan(n))
    return count[0]


def _dct_phase(dev, cyc: float, fp64_per_ms: float) -> dict:
    """``[dct-scipy]``: the kernel against its plain version on the card, bit
    for bit, and both against ``scipy.fftpack`` on the host (the plain
    version's float64 before rounding, the kernel's rounded result), on 10^6
    blocks of each size in both directions.  Half of each corpus is random
    residuals in [-255, 255], half has a sum of n/2 mod n (a half-integer DC:
    the ties scipy's float64 error decides); the IDCT takes the corpus's
    coefficients quantized and rescaled at qp 0 (half) and qp 5 (half).
    Then each mode's time at the compat path's shapes (CIF: 396 blocks of
    16 x 16, 1584 quads of 8 x 8) against its plain version's, and its
    bound.  Returns the kernel's row without its launches."""
    from scipy.fftpack import dct, idct

    from streamoptima_tpu_torch.core.quant import quantize, rescale

    def scipy2(f, a):
        return f(f(a.astype(np.float64), axis=-2, norm="ortho"), axis=-1, norm="ortho")

    total, chunk, checked = 10**6, 250000, 0
    errs = {}  # (n, inverse) -> the largest |kernel - plain| read on the card
    t0 = time.perf_counter()
    for n in (16, 8):
        rng = np.random.default_rng(1200 + n)
        for c0 in range(0, total, chunk):
            x = rng.integers(-255, 256, (chunk, n, n)).astype(np.int64)
            if c0 >= total // 2:  # the tie half
                x[:, 0, 0] -= (x.sum(axis=(1, 2)) - n // 2) % n
            want = scipy2(dct, x)
            coef = np.round(want).astype(np.int64)
            qp = 0 if c0 % (2 * chunk) == 0 else 5
            t = rescale(quantize(torch.from_numpy(coef), qp), qp).numpy()
            for inverse, a, ref in ((False, x, want), (True, t, scipy2(idct, t))):
                a_dev = torch.from_numpy(a).to(dev)
                got = K.dct_scipy(a_dev, inverse)
                err = _check_equal(f"[dct-scipy] n={n} {'idct' if inverse else 'dct'}", got,
                                   K.dct_scipy_plain(a_dev, inverse))
                errs[n, inverse] = max(errs.get((n, inverse), 0), err)
                f64 = (T.idct2_scipy_f64 if inverse else T.dct2_scipy_f64)(a_dev).cpu().numpy()
                _require(np.array_equal(f64.view(np.int64), ref.view(np.int64)),
                         f"[dct-scipy] n={n} {'idct' if inverse else 'dct'}: the plain version's float64 differs "
                         "from scipy's")
                _require(np.array_equal(got.cpu().numpy(), np.round(ref).astype(np.int64)),
                         f"[dct-scipy] n={n} {'idct' if inverse else 'dct'}: the kernel differs from scipy")
                checked += chunk
    check_s = time.perf_counter() - t0
    rng = np.random.default_rng(12)
    modes = {}
    for n, nb in ((16, (CIF_H // 16) * (CIF_W // 16)), (8, 4 * (CIF_H // 16) * (CIF_W // 16))):
        for inverse in (False, True):
            a = torch.from_numpy(rng.integers(-255, 256, (nb, n, n)).astype(np.int64)).to(dev)
            if inverse:
                a = K.dct_scipy(a)
            err = max(errs[n, inverse], _check_equal(f"[dct-scipy] ({nb}, {n}, {n}) {'idct' if inverse else 'dct'}",
                                                     K.dct_scipy(a, inverse), K.dct_scipy_plain(a, inverse)))
            ms, host = _time_ms(lambda: K.dct_scipy(a, inverse), 200, cyc)
            plain_ms, _ = _time_ms(lambda: K.dct_scipy_plain(a, inverse), 10, cyc)
            bound_ms, bound_by = _bound(2 * a.numel() * 8, nb * 2 * n * _line_ops(n, inverse), fp64_per_ms)
            modes[n, inverse] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                 "bound_by": bound_by, "library_ms": None}
            print(f"[dct-scipy] {'idct' if inverse else 'dct'} ({nb}, {n}, {n}) int64: {ms:.4f} ms vs plain "
                  f"{plain_ms:.4f} ms (host enqueue {host:.4f} ms per call); bound {bound_ms:.5f} ms by {bound_by} "
                  f"({_line_ops(n, inverse)} float64 operations a line)", flush=True)
    print(f"[dct-scipy] kernel == plain version on the card, and both == scipy.fftpack on the host (the plain "
          f"version's float64 before rounding, bit for bit): {checked} blocks ({total} of each size, half of them "
          f"half-integer DC ties; both directions, the IDCT at qp 0 and 5), in {check_s:.1f} s", flush=True)
    row = {"name": "dct_scipy", "route": "cuda", "source": "streamoptima_tpu_torch/csrc/dct_scipy.cu",
           "replaces": "streamoptima_tpu/core/transform.py:174", **modes[16, False]}
    for (n, inverse), m in modes.items():
        prefix = ("n8_" if n == 8 else "") + ("inverse_" if inverse else "")
        if prefix:
            row.update({f"{prefix}{k}": v for k, v in m.items()})
    return row


def _step_calls(cfg: CodecConfig, clip: np.ndarray, dev) -> dict:
    """The arguments ``cfg``'s intra step (the clip's frame 0) and inter step
    (frame 1 against frame 0) pass each wrapper of ``STEP_WRAPPERS``, read
    off the wrappers while the steps run on the card: {(step, wrapper):
    (args, kwargs)}, step "intra" or "inter"."""
    got, real, step = {}, {n: getattr(K, n) for n in STEP_WRAPPERS}, ["intra"]

    def capturing(name):
        def capture(*a, **kw):
            got[step[0], name] = (a, kw)
            setattr(K, name, real[name])  # the wrapper counts its launch on its module's name
            try:
                return real[name](*a, **kw)
            finally:
                setattr(K, name, capture)
        return capture

    for name in STEP_WRAPPERS:
        setattr(K, name, capturing(name))
    try:
        codec = TorchCodec(cfg, device=dev)
        f0, f1 = (torch.from_numpy(f).to(dev) for f in clip[:2])
        codec._intra_step(f0)
        step[0] = "inter"
        codec._inter_step(f1, codec.motion.planes([f0]))
    finally:
        for name in STEP_WRAPPERS:
            setattr(K, name, real[name])
    return got


def _random_intra(rng, h: int, w: int, sr: int, dev) -> tuple:
    """Random intra_recon inputs of an (h, w) frame at bs 16 with VBS:
    residuals in +-4080, random splits, MVs in [-sr, 0] and, for one block
    and one quad in eight, out of range (a damaged stream's)."""
    nb = (h // BS_) * (w // BS_)
    mv = rng.integers(-sr, 1, nb)
    smv = rng.integers(-sr, 1, (nb, 4))
    mv = np.where(rng.random(nb) < 0.125, rng.integers(-3 * sr, 3 * sr + 1, nb), mv)
    smv = np.where(rng.random((nb, 4)) < 0.125, rng.integers(-3 * sr, 3 * sr + 1, (nb, 4)), smv)
    mv[:2], smv[0, :2] = (2**31 - 1, -(2**31)), (-(2**31), 2**31 - 1)
    a = (rng.integers(-4080, 4081, (nb, BS_, BS_)), mv, h, w, BS_, sr, rng.integers(-4080, 4081, (nb, 4, 8, 8)),
         rng.random(nb) < 0.5, smv)
    return tuple(torch.from_numpy(np.asarray(x, dtype=np.int32 if x.dtype != bool else bool)).to(dev)
                 if isinstance(x, np.ndarray) else x for x in a)


def _intra_bytes(args: tuple, kw: dict) -> int:
    """Bytes ``intra_recon`` must move on these inputs: its int32 residuals,
    MVs, split flags and sub-MVs read once and the uint8 frame written once."""
    nb, h, w = args[1].shape[0], args[2], args[3]
    vbs = len(args) > 6 and args[6] is not None
    return nb * BS_ * BS_ * 4 * (2 if vbs else 1) + nb * 4 + (nb * (1 + 16) if vbs else 0) + h * w


def _intra_phase(dev, calls: dict, cyc: float) -> dict:
    """``[intra-recon]``: the kernel against its plain version on the card,
    exactly, at 720p on the inputs of ``[main-fast-vbs-fme]``'s and
    ``[main]``'s first intra frames (sr 16 with VBS, sr 8 without), on random
    residuals, splits and MVs (out-of-range ones included) at sr 8 and 16,
    on intra mode 1's transposed call (sr 16, 80 block rows of 45 columns)
    and on a 240-row tile; then the kernel's and the plain version's times
    on the real inputs, the mode-1 call and the tile, and their bounds by
    bytes (the chain's per-column step beside them).  ``calls``: each
    config's ``_step_calls``.  Returns the kernel's row without its
    launches."""
    rng = np.random.default_rng(14)
    sets = {"fast-vbs-fme frame 0": calls["main-fast-vbs-fme"]["intra", "intra_recon"],
            "main frame 0": calls["main"]["intra", "intra_recon"]}
    for sr in (8, 16):
        sets[f"random sr={sr}"] = (_random_intra(rng, H, W, sr, dev), {})
    t = _random_intra(rng, W, H, 16, dev)  # the transposed frame's 80 block rows of 45 blocks
    sets["intra mode 1"] = (t[:2] + (H, W) + t[4:], {"transpose": True})
    sets["tile"] = (_random_intra(rng, H // N_TILES, W, 16, dev), {})
    err = 0
    for name, (a, kw) in sets.items():
        err = max(err, _check_equal(f"[intra-recon] {name}", K.intra_recon(*a, **kw), K.intra_recon_plain(*a, **kw)))
    modes = {}
    for key, name in (("", "fast-vbs-fme frame 0"), ("sr8_", "main frame 0"), ("intra1_", "intra mode 1"),
                      ("tile_", "tile")):
        a, kw = sets[name]
        ms, host = _time_ms(lambda: K.intra_recon(*a, **kw), 200, cyc)
        plain_ms, _ = _time_ms(lambda: K.intra_recon_plain(*a, **kw), 2, cyc)
        nbytes = _intra_bytes(a, kw)
        nbc = (a[2] if kw.get("transpose") else a[3]) // BS_
        bound_ms = nbytes / HBM_BYTES_PER_MS
        modes[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                      "library_ms": None, "step_us": 1e3 * ms / nbc, "bound_step_us": 1e3 * bound_ms / nbc}
        print(f"[intra-recon] {name} ({a[2]}x{a[3]}, sr={a[5]}, VBS {len(a) > 6 and a[6] is not None}"
              f"{', transposed' if kw.get('transpose') else ''}): {ms:.4f} ms ({modes[key]['step_us']:.3f} us a "
              f"column step, {nbc} steps) vs plain {plain_ms:.4f} ms (host enqueue {host:.4f} ms per call); bound "
              f"{bound_ms:.5f} ms by bytes ({nbytes} bytes; {modes[key]['bound_step_us']:.4f} us a step)", flush=True)
    print(f"[intra-recon] kernel == plain version on the card, bit for bit (tolerance 0), on {list(sets)}",
          flush=True)
    row = {"name": "intra_recon", "route": "cuda", "source": "streamoptima_tpu_torch/csrc/intra_recon.cu",
           "replaces": "streamoptima_tpu/core/intra.py:343", **modes[""]}
    for key, m in modes.items():
        if key:
            row.update({f"{key}{k}": v for k, v in m.items()})
    return row


def _hold_timed(name: str, source: str, replaces: str, sets: dict, timed: dict, cost, cyc: float,
                int_ops_per_ms: float) -> dict:
    """One residual-coding kernel against its plain version on the card,
    exactly, on every input set (name -> (args, kwargs)); then for each
    (row key prefix, set name) of ``timed`` the kernel's CUDA-event time
    behind the spin kernel, the plain version's, and the bound from
    ``cost(args, kwargs)`` -> (bytes, operations).  Returns the kernel's row
    without its launches: the first timed set's numbers, the others' under
    their prefixes."""
    fn, plain = KERNELS[name], getattr(K, f"{name}_plain")
    tag = name.replace("_", "-")
    err = max(_check_equal(f"[{tag}] {label}", fn(*a, **kw), plain(*a, **kw)) for label, (a, kw) in sets.items())
    modes = {}
    for key, label in timed.items():
        a, kw = sets[label]
        ms, host = _time_ms(lambda: fn(*a, **kw), 200, cyc)
        plain_ms, _ = _time_ms(lambda: plain(*a, **kw), 3, cyc)
        nbytes, ops = cost(a, kw)
        bound_ms, bound_by = _bound(nbytes, ops, int_ops_per_ms)
        modes[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": None}
        print(f"[{tag}] {label}: {ms:.4f} ms vs plain {plain_ms:.4f} ms (host enqueue {host:.4f} ms per call); "
              f"bound {bound_ms:.5f} ms by {bound_by} ({nbytes} bytes, {ops} operations)", flush=True)
    print(f"[{tag}] kernel == plain version on the card, bit for bit (tolerance 0), on {list(sets)}: max_abs_err "
          f"{err}", flush=True)
    row = {"name": name, "route": "cuda", "source": f"streamoptima_tpu_torch/csrc/{source}", "replaces": replaces,
           **modes[next(iter(timed))]}
    for key, m in list(modes.items())[1:]:
        row.update({f"{key}{k}": v for k, v in m.items()})
    return row


def _confirm_cost(a: tuple, kw: dict) -> tuple[int, int]:
    """``fast_confirm``'s bytes (the regions, the int32 pixels, MVPs and
    origins read once, the winners written once) and operations (every
    candidate's pixel abs-diffs, nine a reference per block; the quads'
    are the same pixels)."""
    win, cur, fme, vbs = a[0], a[1], a[7], a[8]
    nb, P = win.shape[:2]
    nref = P // 4 if fme else P
    nbytes = win.numel() + cur.numel() * 4 + nb * (12 + 8) + nb * (5 if vbs else 1) * (12 + 4 + 1)
    return nbytes, nb * 9 * nref * cur[0].numel()


def _hold_confirm(mode: str, solver: TorchCodec, sets: dict, g_conv, g_wild, cyc: float,
                  int_ops_per_ms: float) -> dict:
    """``[fast-confirm]``: the kernel against ``core.fastme.confirm`` on the
    card, exactly, with the engine's arguments (``Motion.confirm``'s:
    ``window_fetch``'s regions at ``region_base``) on every input set at the
    converged MVPs ``g_conv`` and at ``g_wild``; then its time, the plain
    version's and the bound at the clip's converged MVPs.  Returns its row
    without its launches."""
    fme, bs = solver.motion.fme, solver.bs
    scale = 2 if fme else 1
    dims = (2 * H - 1, 2 * W - 1) if fme else (H, W)
    calls = {}
    for name, (c, p) in sets.items():
        for gname, g in (("converged", g_conv), ("wild", g_wild)):
            by0, bx0 = FM.region_base(g, solver.motion.by, solver.motion.bx, fme)
            win = K.window_fetch(p.reshape(-1, H, W), by0, bx0, bs + 2)
            calls[f"{name} {gname}"] = ((win, blockify(c, bs).to(torch.int32), g, scale * solver.motion.bx,
                                         scale * solver.motion.by, bs, dims, fme, solver.vbs), {})
    row = _hold_timed("fast_confirm", "fast_confirm.cu", "streamoptima_tpu/core/fastme.py:1063 (the jitted confirm; "
                      "no TPU kernel)", calls, {"": "clip converged"}, _confirm_cost, cyc, int_ops_per_ms)
    print(f"[fast-confirm] 720p {mode}, VBS {solver.vbs} ({calls['clip converged'][0][0].shape[0]} blocks, "
          f"{tuple(calls['clip converged'][0][0].shape[1:])} regions): held on {list(calls)}", flush=True)
    return row


def _select_cost(a: tuple, kw: dict) -> tuple[int, int]:
    """``transform_select``'s bytes (its inputs read once, its outputs
    written once, the quad planes zeros without VBS) and operations (the
    int64 multiply-adds of both passes of each DCT)."""
    res, nb, bs = a[0], a[0].shape[0], a[0].shape[-1]
    vbs = kw["vbs_enable"]
    n_in = res.numel() * 4 + nb * 8 + (nb if kw.get("ok_full") is not None else 0)
    if vbs:
        n_in += a[1].numel() * 4 + nb * 16 + nb + (4 * nb if kw.get("ok_quads") is not None else 0)
    return n_in + nb * (1 + 8) + 2 * res.numel() * 4, res.numel() * 2 * (bs + (bs // 2 if vbs else 0))


def _recon_cost(a: tuple, kw: dict) -> tuple[int, int]:
    """``residual_recon``'s bytes and multiply-adds on these inputs: an
    intra call reads both variants and writes int32 residuals; an inter
    call reads the coefficients and prediction pixels of the variant each
    block uses (split flags, quads), the flags, and writes the frame."""
    qf, qq, qps = a[:3]
    nb, bs = qf.shape[0], qf.shape[-1]
    px, cb = bs * bs, qf.element_size()
    pred = a[3] if len(a) > 3 else None
    if pred is None:
        nvar = 1 if qq is None else 2
        return nvar * nb * px * (cb + 4) + nb * 4, nb * px * 2 * (bs + (0 if qq is None else bs // 2))
    nsplit = int(a[5].sum()) if qq is not None else 0
    flags = sum(t.numel() for t in a[5:8] if t is not None)
    ops = (nb - nsplit) * px * 2 * bs + nsplit * px * 2 * (bs // 2)
    return nb * px * (cb + 2) + nb * 4 + flags + pred.numel(), ops


def _search_cost(a: tuple, kw: dict) -> tuple[int, int]:
    """``intra_search``'s bytes (the frame read once; MVs, SADs and the int32
    residuals written once) and operations (an abs-diff a pixel for each of
    the sr + 1 distinct shifts)."""
    cur, bs, sr, _, vbs = a
    nb = cur.numel() // (bs * bs)
    return cur.numel() + nb * (8 + (32 if vbs else 0)) + nb * bs * bs * 4 * (2 if vbs else 1), nb * (sr + 1) * bs * bs


def _residual_phases(dev, calls: dict, cyc: float, int_ops_per_ms: float) -> dict:
    """``[transform-select]``, ``[residual-recon]`` and ``[intra-search]``:
    each kernel against its plain version on the card, exactly, at 720p on
    the arguments ``[main]``'s, ``[main-fast-vbs-fme]``'s and
    ``[main-intra1]``'s intra and inter steps pass it (``calls``), and on
    extremes: ±255 checkerboards, zero blocks and blocks without a valid
    candidate at QPs 0, 4 and 11 (the select); the same coefficients,
    int16 as decode passes them, with the ok masks (the recon); flat (every
    shift ties), checkerboard and noise frames in both intra modes, on the
    frame's canvas and a wider one (the search).  Then each kernel's time,
    its plain version's and its bound.  Returns {kernel: row without its
    launches}."""
    rng = np.random.default_rng(15)
    nb, s = (H // BS_) * (W // BS_), BS_ // 2
    # the select at the extremes: VBS, an inter frame
    res = rng.integers(-255, 256, (nb, BS_, BS_)) * (rng.random((nb, 1, 1)) < rng.random((nb, BS_, BS_)))
    i, j = np.indices((BS_, BS_))
    for k, p in enumerate((1, 2, 4)):
        res[3 * k::97] = np.where(((i // p) + (j // p)) % 2 == 0, 255, -255)
    res[5::53] = 0
    quads = res.reshape(nb, 2, s, 2, s).swapaxes(2, 3).reshape(nb, 4, s, s).copy()
    quads[1::3] = rng.integers(-255, 256, quads[1::3].shape)
    ok, sub_ok = rng.random(nb) < 0.9, rng.random((nb, 4)) < 0.9
    sad = np.where(ok, rng.integers(0, 255 * BS_ * BS_ + 1, nb), 2**31 - 1)
    sub_sad = np.where(sub_ok, rng.integers(0, 255 * s * s + 1, (nb, 4)), 2**31 - 1)
    dv = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in (
        ("res", res.astype(np.int32)), ("quads", quads.astype(np.int32)), ("sad", sad.astype(np.int32)),
        ("sub_sad", sub_sad.astype(np.int32)), ("ok", ok), ("sub_ok", sub_ok),
        ("qps", rng.integers(0, 13, nb).astype(np.int32)), ("elig", rng.random(nb) < 0.8))}
    sel = {f"{label} {st}": calls[label][st, "transform_select"] for label in calls for st in ("intra", "inter")}
    for qp in (0, 4, 11):
        sel[f"extremes qp {qp}"] = ((dv["res"], dv["quads"], dv["sad"], dv["sub_sad"], 1, dv["qps"]),
                                    dict(qp_nominal=qp, lam=0.015, vbs_enable=True, vbs_eligible=dv["elig"], bs=BS_,
                                         sbs=s, ok_full=dv["ok"], ok_quads=dv["sub_ok"]))
    rows = {"transform_select": _hold_timed(
        "transform_select", "transform_select.cu", "streamoptima_tpu/core/rd.py:27", sel,
        {"": "main-fast-vbs-fme inter", "intra_": "main-fast-vbs-fme intra", "main_": "main inter",
         "intra1_": "main-intra1 intra"}, _select_cost, cyc, int_ops_per_ms)}

    # the recon: the steps' calls, the fast path's inter call as decode makes it (int16, the unused half zero),
    # and the extremes' coefficients
    rec = {f"{label} {st}": calls[label][st, "residual_recon"] for label in calls for st in ("intra", "inter")}
    a, kw = calls["main-fast-vbs-fme"]["inter", "residual_recon"]
    sp = a[5]
    rec["main-fast-vbs-fme decode"] = ((torch.where(sp[:, None, None], 0, a[0]).to(torch.int16),
                                        torch.where(sp[:, None, None, None], a[1], 0).to(torch.int16)) + a[2:], kw)
    _, qf, qq, _, _ = K.transform_select(*sel["extremes qp 0"][0], **sel["extremes qp 0"][1])
    planes = torch.from_numpy(rng.integers(0, 256, (2, H, W)).astype(np.int16)).to(dev)
    rec["extremes"] = ((qf.to(torch.int16), qq.to(torch.int16), dv["qps"], planes[0], planes[1],
                        dv["elig"], dv["ok"], dv["sub_ok"]), {})
    rows["residual_recon"] = _hold_timed(
        "residual_recon", "residual_recon.cu", "streamoptima_tpu/jax_engine.py:658", rec,
        {"": "main-fast-vbs-fme decode", "encode_": "main-fast-vbs-fme inter", "intra_": "main-fast-vbs-fme intra",
         "main_": "main inter"}, _recon_cost, cyc, int_ops_per_ms)

    # the search: the steps' calls and the extreme frames, both modes, the frame's canvas and a wider one
    srch = {f"{label} frame 0": calls[label]["intra", "intra_search"] for label in calls}
    frames = {"flat": np.full((H, W), 128, np.uint8), "checker": np.where(np.indices((H, W)).sum(0) % 2, 255, 0),
              "noise": rng.integers(0, 256, (H, W))}
    for kind, f in frames.items():
        f = torch.from_numpy(f.astype(np.uint8)).to(dev)
        for transpose in (False, True):
            canvas = H if transpose else W
            srch[f"{kind} mode {int(transpose)}"] = ((f, BS_, 16, canvas, True), {"transpose": transpose})
        srch[f"{kind} canvas +64"] = ((f, BS_, 16, W + 64, True), {"transpose": False})
    rows["intra_search"] = _hold_timed(
        "intra_search", "intra_search.cu", "streamoptima_tpu/core/intra.py:46", srch,
        {"": "main-fast-vbs-fme frame 0", "sr8_": "main frame 0", "intra1_": "main-intra1 frame 0"}, _search_cost,
        cyc, int_ops_per_ms)
    return rows


def _rle_cost(cols: list, cap: int) -> int:
    """``rle_pack``'s bytes: each block's split flag, MVs and the
    coefficients of the variant it uses read once; the header, the
    symbols and the totals written once."""
    nbytes = 0
    for sp, mv, smv, qf, _ in zip(*cols):
        nb = sp.shape[0]
        nsplit = int(sp.sum())
        nbytes += nb * (1 + qf[0].numel() * 2 + mv.numel() // nb * 4) + nsplit * (smv.numel() // nb) * 4
    _, s0 = K.rle_pack_layout(len(cols[0]), cols[0][0].shape[0])
    return nbytes + 2 * (s0 + cap)


def _rle_phase(dev, pkg: dict, cyc: float) -> dict:
    """``[rle-pack]``: the container's coding kernel against its plain
    version on the card, exactly, on ``[main-fast-vbs-fme]``'s 16 frames
    (the encode cell's shapes), on a copy with every block split and one
    with none, and at a capacity short by 5 (symbols dropped, flagged); then
    its time, the plain version's and the bound (bytes).  Returns its row
    without its launches."""
    cols = [[o[k] for o in pkg["per_frame"]] for k in ("split", "mv", "sub_mv", "qtc_full", "qtc_quads")]
    cap = sum(pkg["residual size per frame"])

    def with_split(flag: bool) -> tuple:
        sp = [torch.full_like(t, flag) for t in cols[0]]
        plain = K.rle_pack_plain(sp, *cols[1:], 0)
        return (sp, *cols[1:]), int(plain[: 4 * len(sp)].view(torch.int32).sum())

    sets = {"segment": (tuple(cols), cap), "every block split": with_split(True),
            "no block split": with_split(False), "short by 5": (tuple(cols), cap - 5)}
    err = 0
    for label, (a, c) in sets.items():
        err = max(err, _check_equal(f"[rle-pack] {label}", K.rle_pack(*a, c), K.rle_pack_plain(*a, c)))
    got = K.rle_pack(*cols, cap)
    totals = got[: 4 * len(cols[0])].view(torch.int32).reshape(-1, 2).sum(1).tolist()
    _require(totals == pkg["residual size per frame"], f"[rle-pack] totals {totals} differ from the package's sizes")
    ms, host = _time_ms(lambda: K.rle_pack(*cols, cap), 50, cyc)
    plain_ms, _ = _time_ms(lambda: K.rle_pack_plain(*cols, cap), 2, cyc)
    nbytes = _rle_cost(cols, cap)
    bound_ms, bound_by = _bound(nbytes, 0, 1.0)
    print(f"[rle-pack] {len(cols[0])} frames 720p, {cap} symbols: {ms:.4f} ms a segment (two launches) vs plain "
          f"{plain_ms:.4f} ms (host enqueue {host:.4f} ms per call); bound {bound_ms:.5f} ms by {bound_by} "
          f"({nbytes} bytes); kernel == plain version on the card, bit for bit, on {list(sets)}", flush=True)
    return {"name": "rle_pack", "route": "cuda", "source": "streamoptima_tpu_torch/csrc/rle_pack.cu",
            "replaces": "streamoptima_tpu/native/entropy.cpp:163 (host)", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _unpack_phase(dev, codec: VideoCodec, cyc: float) -> dict:
    """``[rle-unpack]``: the container's decoding kernel against its plain
    version on the card, exactly, and against the host route's payload, on
    ``codec``'s container (``[main-fast-vbs-fme]``'s 16 frames: the decode
    cell's shapes), over the buffer the decoders upload; then its time, the
    plain version's, the host RLE's (``native``, the route it replaces, over
    the same lists) and the bound (bytes).  Returns its row without its
    launches."""
    cfg = codec.cfg
    with tempfile.TemporaryDirectory() as d:
        codec.transmit_bitstream_binary(Path(d) / "u.sob")
        fts, mvs, _, res = BIN.read_binary(Path(d) / "u.sob", cfg)
    pay = pack_stream(cfg, fts, res, mvs)[3]
    host = np.zeros(pay.nbytes, np.uint8)
    pay.fill(host)
    buf = torch.from_numpy(host).to(dev)
    shape = (cfg.frames, cfg.n_blocks, cfg.block_size)
    got = K.rle_unpack(buf, *shape)
    err = _check_equal("[rle-unpack] segment", got, K.rle_unpack_plain(buf, *shape))
    dense = pack_stream(cfg, fts, [BS.FrameResArrays(r.split, r.qf, r.qq) for r in res], mvs)[3]
    _require(np.array_equal(got.cpu().numpy(), dense), "[rle-unpack] the payload differs from the host route's")
    ms, host_ms = _time_ms(lambda: K.rle_unpack(buf, *shape), 50, cyc)
    plain_ms, _ = _time_ms(lambda: K.rle_unpack_plain(buf, *shape), 2, cyc)
    t0 = time.perf_counter()
    for r in res:
        native.rle_decode_blocks(r.vals_f, r.offs_f, cfg.block_size)
        native.rle_decode_blocks(r.vals_q, r.offs_q, cfg.sub_block_size)
    native_ms = (time.perf_counter() - t0) * 1e3
    nbytes = pay.nbytes + 2 * got.numel()  # the buffer read once, the payload written once
    bound_ms, bound_by = _bound(nbytes, 0, 1.0)
    symbols = sum(len(r.vals_f) + len(r.vals_q) for r in res)
    print(f"[rle-unpack] {cfg.frames} frames 720p, {symbols} symbols: {ms:.4f} ms a segment (one launch) vs plain "
          f"{plain_ms:.4f} ms (host enqueue {host_ms:.4f} ms per call) and the host RLE (native) {native_ms:.4f} ms; "
          f"bound {bound_ms:.5f} ms by {bound_by} ({nbytes} bytes); kernel == plain version on the card and == the "
          "host route's payload, bit for bit", flush=True)
    return {"name": "rle_unpack", "route": "cuda", "source": "streamoptima_tpu_torch/csrc/rle_unpack.cu",
            "replaces": "streamoptima_tpu/native/entropy.cpp:209 (host)", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "native_ms": native_ms}


def _compat_phase(dev) -> dict:
    """The compat engine's paths, each run on the card with every kernel's
    launches counted from 0 just before it, and again on the CPU (the plain
    versions), whose MV file, residual file and decoded YUV it must equal
    byte for byte; each decode must equal its reconstruction.

    ``[compat]``: ``main.main`` in this process with ``--synthetic --engine
    compat``, the command line's defaults (CIF, 21 frames, fast ME + VBS +
    FME, sr 16, qp 5).  ``[compat-vbs-fme]``: the same with ``--frames 8
    --no-fast-me``, full search with VBS + FME (the search kernel's FME mode
    with the quads, and the fetch at the quads' own margin for the residual
    and at the parent's, K18, for the reconstruction and decode).
    ``[compat-rc-promote]``: through the facade, CIF 8 frames whole-pel at
    ``rc_flag=2`` on a clip cut to noise at frame 4, ``intra_thresh`` twice
    the largest inter frame of frames 1-3 of an ``rc_flag=1`` encode of the
    clip in the same run: frame 4 must be promoted."""
    out = {}
    clip = synthetic_clip(CIF_H, CIF_W, CIF_FRAMES)
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)

        def files(tag: str) -> list:
            return ["--mv-file", str(d / f"{tag}mv.txt"), "--residual-file", str(d / f"{tag}res.txt"), "--out",
                    str(d / f"{tag}dec.yuv"), "--recon-out", str(d / f"{tag}rec.yuv")]

        def held(label: str, tag: str, src: np.ndarray) -> float:
            """The card's files (``g``) == the CPU's (``c``); decode == recon; the mean PSNR against ``src``."""
            for name in ("mv.txt", "res.txt", "dec.yuv", "rec.yuv"):
                _require((d / f"g{tag}{name}").read_bytes() == (d / f"c{tag}{name}").read_bytes(),
                         f"[{label}] the card's {name} differs from the CPU run's")
            _require((d / f"g{tag}dec.yuv").read_bytes() == (d / f"g{tag}rec.yuv").read_bytes(),
                     f"[{label}] decoded != recon")
            rec = np.fromfile(d / f"g{tag}rec.yuv", dtype=np.uint8).reshape(src.shape)
            err = ((rec.astype(np.float64) - src) ** 2).mean(axis=(1, 2))
            return float(np.mean(10 * np.log10(255.0 ** 2 / err)))

        argvs = {"compat": ["--synthetic", "--engine", "compat"],
                 "compat-vbs-fme": ["--synthetic", "--engine", "compat", "--frames", "8", "--no-fast-me"]}
        for label, argv in argvs.items():
            chained = []  # the passes of each fast-ME chain, read off motion.fast_chain
            chain = MO.fast_chain

            def recording(*a, **k):
                gs, passes = chain(*a, **k)
                chained.append(passes)
                return gs, passes

            _zero_counts()
            MO.fast_chain = recording
            try:
                t0 = time.perf_counter()
                rc_g = cli_main(argv + files(f"g{label}"))
                g_s = time.perf_counter() - t0
            finally:
                MO.fast_chain = chain
            launches = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}
            margin = K.pred_fetch_fme_vbs.margin_launches
            _require(rc_g == 0, f"[{label}] exited {rc_g} on the card")
            t0 = time.perf_counter()
            rc_c = cli_main(argv + ["--device", "cpu"] + files(f"c{label}"))
            c_s = time.perf_counter() - t0
            _require(rc_c == 0, f"[{label}] exited {rc_c} on the CPU")
            frames = CIF_FRAMES if label == "compat" else 8
            psnr = held(label, label, synthetic_clip(CIF_H, CIF_W, frames))
            n_inter = frames - 1
            if label == "compat":  # per inter frame: the chain, one confirm, two fetches (K18) and one in decode
                want = {"rowscan_pass": sum(chained), "window_fetch": n_inter, "fast_confirm": n_inter,
                        "pred_fetch_fme_vbs": 3 * n_inter,
                        "dct_scipy": 4 * frames + 2 * frames, "intra_recon": 2, "intra_search": 1}
                _require(len(chained) == n_inter, f"[{label}] solved {len(chained)} chains")
            else:
                want = {"full_search_fme_vbs": n_inter, "pred_fetch_fme_vbs": 3 * n_inter,  # frame 0 searched once,
                        "dct_scipy": 4 * frames + 2 * frames, "intra_recon": 2, "intra_search": 1}  # rebuilt twice
            _require(launches == want, f"[{label}] launches {launches}, expected {want}")
            # the reconstruction's fetch and the decode's take the parent's margin (K18), the residual's its own
            _require(margin == 2 * n_inter, f"[{label}] {margin} fetches at quad_margin={BS_}, expected "
                     f"{2 * n_inter}")
            _require(np.isfinite(psnr) and psnr > MIN_PSNR, f"[{label}] mean PSNR {psnr}")
            out[label] = {"launches": launches, "margin_launches": margin, "s": g_s}
            print(f"[{label}] command line {' '.join(argv)} (CIF {frames} frames): exit 0 in {g_s:.2f} s on the "
                  f"card ({frames / g_s:.2f} frames/s, encode + SSIM + text stream + decode + files), "
                  f"{c_s:.2f} s on the CPU; mv.txt, res.txt, decoded and reconstructed YUV == the --device cpu "
                  f"run's, byte for byte; decoded == recon; mean PSNR {psnr:.4f} dB; launches {launches}, "
                  f"{margin} of pred_fetch_fme_vbs's at quad_margin={BS_} (K18)"
                  + (f" (rowscan_pass passes per inter frame {chained})" if chained else ""), flush=True)

        # [compat-rc-promote]: the facade, whole-pel, rate control with promotion at a cut to noise
        label = "compat-rc-promote"
        cut = np.concatenate([clip[:4], synthetic_clip(CIF_H, CIF_W, 4, seed=7, smooth=False)])
        base = dict(height=CIF_H, width=CIF_W, frames=8, block_size=16, search_range=16, qp=5, intra_dur=21,
                    lam=0.015, engine="compat", target_br="3 mbps", frame_rate=30, qp_rate_tables=RC_TABLES)
        first = CompatCodec(CodecConfig(**base, rc_flag=1), cut, device=dev).encode()
        thresh = 2 * max(first["residual size per frame"][1:4])
        cfg = CodecConfig(**base, rc_flag=2, intra_thresh=thresh)
        for tag, where in (("g", dev), ("c", "cpu")):
            _zero_counts()
            t0 = time.perf_counter()
            codec = VideoCodec(cfg, cut, device=where)
            pkg = codec.encode()
            codec.transmit_bitstream(d / f"{tag}{label}mv.txt", d / f"{tag}{label}res.txt")
            codec.save_reconstructed(d / f"{tag}{label}rec.yuv")
            dec = VideoCodec(cfg, device=where)
            dec.decode_bitstream(d / f"{tag}{label}mv.txt", d / f"{tag}{label}res.txt")
            dec.save_decoded_frames(d / f"{tag}{label}dec.yuv")
            if tag == "g":
                g_s = time.perf_counter() - t0
                launches = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}
                types = pkg["frame_type_seq"]
        psnr = held(label, label, cut)
        _require(types[0] == 0 and types[4] == 0 and types[1:4] == [1, 1, 1], f"[{label}] frame types {types}")
        promoted = types[1:].count(0)
        want = {"full_search": 7, "pred_fetch": types.count(1), "dct_scipy": 2 * (7 + 1 + promoted) + 8,
                "intra_recon": 2 * types.count(0), "intra_search": types.count(0)}
        _require(launches == want, f"[{label}] launches {launches}, expected {want}")
        _require(np.isfinite(psnr) and psnr > PROMOTE_MIN_PSNR, f"[{label}] mean PSNR {psnr}")
        out[label] = {"launches": launches, "s": g_s}
        print(f"[{label}] facade, CIF 8 frames whole-pel, rc_flag 2, intra_thresh {thresh} (twice the largest of "
              f"frames 1-3 at rc_flag 1): frame types {types}, row QPs of frame 0 {pkg['Qp_per_row_per_frame'][0]}; "
              f"encode + text stream + decode {g_s:.2f} s on the card; mv.txt, res.txt, decoded and reconstructed "
              f"YUV == the CPU run's, byte for byte; decoded == recon; mean PSNR {psnr:.4f} dB; launches {launches}",
              flush=True)
    return out


def _drift_ramp(h: int, w: int) -> np.ndarray:
    """A reference whose SAD against an all-zero block falls toward the
    bottom-right corner, so every fast-ME step moves its MVP one step that
    way while it stays valid: the prefetched regions cross the plane edges.
    Even values <= 126, so half-pel row sums never wrap and a half-pel
    average lies strictly between two different neighbours."""
    yy, xx = np.mgrid[0:h, 0:w]
    return (2 * np.minimum((h + w - xx - yy) // 32, 63)).astype(np.uint8)


def _adversarial_mvs(rng, nb: int, bound: int) -> np.ndarray:
    mv = np.stack([rng.integers(-bound, bound + 1, nb), rng.integers(-bound, bound + 1, nb),
                   np.zeros(nb, int)], 1).astype(np.int32)
    mv[:: W // BS_, 0] = -bound  # left column: windows leave the frame
    mv[-(W // BS_):, 1] = bound  # bottom row too
    mv[7] = (5000, -5000, 0)  # entirely outside
    return mv


def _drive(label: str, extra: dict, clip: np.ndarray, dev, frames: int = FRAMES, mesh: bool = False,
           types: list | None = None, min_psnr: float = MIN_PSNR, **expected) -> dict:
    """One path through the facade: encode -> text bitstream -> decode from
    the files -> in-memory decode, each bit-exact with the encoder's
    reconstructions.  Every kernel's launch count is zeroed just before the
    encode and read just after the file decode; ``expected`` names the
    kernels the path must launch and how often ("passes": the encode's
    ``rowscan_pass`` passes, on the mesh one launch per tile a pass), every
    other kernel never.  ``mesh``: on the six-shard mesh of the card, not on
    the device.  ``types``: the frame types the encode must give (default:
    an intra frame every ``INTRA_DUR``); ``min_psnr``: the mean PSNR's floor
    in dB."""
    clip = clip[:frames]

    def where(cfg):
        return {"mesh": make_mesh(cfg, devices=[dev] * N_SHARDS)} if mesh else {"device": dev}

    warm_cfg = _cfg(frames=3, **extra)
    warm = VideoCodec(warm_cfg, clip[:3], **where(warm_cfg))  # one-time library / allocator set-up
    warm.encode(compute_ssim=False, package=False)
    cfg = _cfg(frames=frames, **extra)
    if mesh:
        _require(where(cfg)["mesh"].devices.shape == (N_SHARDS // N_TILES, N_TILES), f"{label}: mesh shape")
    _zero_counts()
    enc = VideoCodec(cfg, clip, **where(cfg))
    torch.cuda.synchronize()
    pkg = enc.encode(package=False)  # ends in a device-to-host copy of the stats: synchronised
    enc_s = pkg["timing"]["total_s"]
    with tempfile.TemporaryDirectory() as d:
        mv_f, res_f = Path(d) / "mv.txt", Path(d) / "res.txt"
        t0 = time.perf_counter()
        enc.transmit_bitstream(mv_f, res_f)
        tx_s = time.perf_counter() - t0
        dec = VideoCodec(cfg, **where(cfg))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decoded = dec.decode_bitstream(mv_f, res_f)  # ends in a device-to-host copy
        dec_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}
        t0 = time.perf_counter()
        parsed = dec.parse_bitstream(mv_f, res_f)
        parse_s = time.perf_counter() - t0
        n_bytes = mv_f.stat().st_size + res_f.stat().st_size
    recon = pkg["reconstructed frames"]
    _require(decoded.shape == recon.shape == (frames, H, W) and decoded.dtype == np.uint8, f"{label}: decoded shape")
    _require(np.array_equal(decoded, recon), f"{label}: decoded frames differ from the encoder's reconstructions")
    psnr = np.asarray(pkg["PSNR per frame"])
    _require(np.isfinite(psnr).all() and psnr.mean() > min_psnr, f"{label}: PSNR {psnr}")
    if types is None:
        types = [1] * frames if extra.get("parallel_mode") == 1 else [0 if i % INTRA_DUR == 0 else 1
                                                                     for i in range(frames)]
    _require(pkg["frame_type_seq"] == types, f"{label}: frame types {pkg['frame_type_seq']}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames2 = dec.decode(*parsed)  # in-memory decode of the parsed stream; ends in a device-to-host copy
    dec_mem_s = time.perf_counter() - t0
    _require(np.array_equal(frames2, recon), f"{label}: in-memory decode differs")
    n_inter = types.count(1)
    print(f"[{label}] 720p {frames} frames ({n_inter} inter): encode {frames / enc_s:.2f} fps ({enc_s:.4f} s), "
          f"text bitstream write {tx_s:.3f} s ({n_bytes} bytes), decode_bitstream {frames / dec_s:.2f} fps "
          f"({dec_s:.4f} s incl. parse; parse alone {parse_s:.3f} s), in-memory decode "
          f"{frames / dec_mem_s:.2f} fps ({dec_mem_s:.4f} s); decode == recon bit-exact; launches {launches}",
          flush=True)
    print(f"[{label}] mean PSNR {psnr.mean():.4f} dB, mean SSIM {np.mean(pkg['SSIM per frame']):.5f} "
          f"({pkg['timing']['ssim_s']:.4f} s on the device, besides the encode), bits "
          f"{sum(pkg['residual size per frame'])}", flush=True)
    # every intra frame is one intra_recon launch per tile in the encode (in each pass of two-pass) and in the
    # decode, and one intra_search in the encode; every frame step of the encode (a promoted frame's inter step
    # and its intra step) one transform_select and one residual_recon, every decoded frame one residual_recon
    n_intra, tiles = types.count(0), N_TILES if mesh else 1
    enc_passes = 2 if extra.get("two_pass") else 1
    promoted = n_intra - (0 if extra.get("parallel_mode") == 1 else len(range(0, frames, INTRA_DUR)))
    steps = enc_passes * frames + promoted
    expected.setdefault("intra_recon", tiles * n_intra * (enc_passes + 1))
    expected.setdefault("intra_search", tiles * n_intra * enc_passes)
    expected.setdefault("transform_select", tiles * steps)
    expected.setdefault("residual_recon", tiles * (steps + frames))
    passes = pkg.get("fast_me_passes")
    if passes is not None:  # parallel mode 2 runs no chain; every other fast-ME path one or more passes a frame
        chain = extra.get("parallel_mode") != 2
        _require(passes == [] if not chain else len(passes) == n_inter and min(passes) >= 1,
                 f"{label}: passes per inter frame {passes}")
        print(f"[{label}] rowscan_pass passes per inter frame {passes}", flush=True)
        expected = {k: ((N_TILES if mesh else 1) * sum(passes) if v == "passes" else v) for k, v in expected.items()}
    _require(launches == {k: v for k, v in expected.items() if v},
             f"kernel launches in the {label} path {launches}, expected {expected}")
    if extra.get("rc_flag"):
        print(f"[{label}] row QPs of frames 0 and 1: {pkg['Qp_per_row_per_frame'][:2]}", flush=True)
    return {"launches": launches, "pkg": pkg, "n_inter": n_inter, "enc_s": enc_s, "codec": enc, "cfg": cfg}


def _stream_bytes(pkg: dict, cfg: CodecConfig) -> bytes:
    """The text bitstream of an encode(package=False) package."""
    pairs = [frame_arrays_of(o, ft) for o, ft in zip(pkg["per_frame"], pkg["frame_type_seq"])]
    with tempfile.TemporaryDirectory() as d:
        mv_f, res_f = Path(d) / "mv.txt", Path(d) / "res.txt"
        BS.write_bitstream(mv_f, res_f, pkg["frame_type_seq"], [m for m, _ in pairs], pkg["Qp_per_row_per_frame"],
                           [r for _, r in pairs], cfg)
        return mv_f.read_bytes() + b"|" + res_f.read_bytes()


def _require_same_encode(what: str, a: dict, b: dict) -> None:
    """Two encode(package=False) packages equal bit for bit."""
    for k in ("frame_type_seq", "residual size per frame", "PSNR per frame", "MAE per Frame"):
        _require(a[k] == b[k], f"{what}: {k} differs")
    _require(np.array_equal(a["reconstructed frames"], b["reconstructed frames"]), f"{what}: reconstructions differ")
    for i, (fa, fb) in enumerate(zip(a["per_frame"], b["per_frame"])):
        for k in ("mv", "split", "sub_mv", "qtc_full", "qtc_quads", "row_bits"):
            _require(torch.equal(fa[k].cpu(), fb[k].cpu()), f"{what}: frame {i} {k} differs")


def _check_mesh(label: str, extra: dict, clip: np.ndarray, dev, run: dict, frames: int = FRAMES) -> VideoCodec:
    """A mesh path's encode against the single-device encode and against the
    all-gather mesh encode, bit for bit (after the counted run).  Returns
    the single-device codec, its encode done."""
    cfg = _cfg(frames=frames, **extra)
    clip = clip[:frames]
    one = VideoCodec(cfg, clip, device=dev)
    single = one.encode(compute_ssim=False, package=False)
    _require_same_encode(f"{label} vs the single-device encode", run["pkg"], single)
    _require(_stream_bytes(run["pkg"], cfg) == _stream_bytes(single, cfg), f"{label}: text bitstream bytes differ")
    gathered = ShardedCodec(cfg, make_mesh(cfg, devices=[dev] * N_SHARDS), clip, tile_comm="all_gather")
    _require_same_encode(f"{label} all_gather vs halo", gathered.encode(package=False), run["pkg"])
    for k in ("frame_type_seq", "Qp_per_row_per_frame"):
        _require(run["pkg"][k] == single[k], f"{label}: {k} differs from the single-device encode")
    print(f"[{label}] == the single-device encode (MVs, coefficients, sizes, PSNR, recon, frame types, row QPs, text "
          f"bitstream bytes) and == tile_comm='all_gather', bit for bit", flush=True)
    return one


def _binary_phase(dev, pairs: dict) -> dict:
    """The binary container: ``pairs``: label -> (the single-device codec,
    the mesh codec, the mesh's package) of one whole-pel config, each codec
    after its encode.  Each writes the container; the two files are
    byte-equal, and each decodes, on one device and on the mesh, to the
    reconstructions, with one fetch per inter frame (on the mesh one per
    tile) and one ``rle_unpack`` launch.  Each write codes the encode's
    coefficients on the card: two ``rle_pack`` launches and no other kernel.
    Returns the writes' ``rle_pack`` launches and the decodes'
    ``rle_unpack`` launches."""
    rle_launches = unpack_launches = 0
    with tempfile.TemporaryDirectory() as d:
        for label, (one, on_mesh, pkg) in pairs.items():
            cfg = one.cfg
            _require(not (cfg.vbs_enable or cfg.fme_enable or cfg.fast_me), f"[binary] {label}: not whole-pel")
            files, write_s = [], []
            for tag, codec in (("device", one), ("mesh", on_mesh)):
                files.append(Path(d) / f"{label}-{tag}.sob")
                _zero_counts()
                t0 = time.perf_counter()
                codec.transmit_bitstream_binary(files[-1])
                write_s.append(time.perf_counter() - t0)
                launches = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}
                _require(launches == {"rle_pack": 2}, f"[binary] {label} {tag}: write launches {launches}")
                rle_launches += 2
            _require(files[0].read_bytes() == files[1].read_bytes(),
                     f"[binary] {label}: the one-device and the mesh container differ")
            n_inter = pkg["frame_type_seq"].count(1)
            decodes = []
            for f in files:
                for mesh in (False, True):
                    where = {"mesh": make_mesh(cfg, devices=[dev] * N_SHARDS)} if mesh else {"device": dev}
                    _zero_counts()
                    t0 = time.perf_counter()
                    dec = VideoCodec(cfg, **where).decode_bitstream_binary(f)  # ends in a device-to-host copy
                    decodes.append(time.perf_counter() - t0)
                    launches = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}
                    _require(np.array_equal(dec, pkg["reconstructed frames"]),
                             f"[binary] {label}: the decode of {f.name} on {'the mesh' if mesh else 'one device'} "
                             "differs from the reconstructions")
                    want = {"pred_fetch": n_inter * (N_TILES if mesh else 1),
                            "intra_recon": pkg["frame_type_seq"].count(0) * (N_TILES if mesh else 1),
                            "residual_recon": cfg.frames * (N_TILES if mesh else 1), "rle_unpack": 1}
                    _require(launches == want, f"[binary] {label}: decode launches {launches}, expected {want}")
                    unpack_launches += 1
            print(f"[binary] {label}: 720p {cfg.frames} frames, SOTPB1 {files[0].stat().st_size} bytes written in "
                  f"{write_s[0]:.3f} s (one device) and {write_s[1]:.3f} s (mesh), byte-equal; decode_bitstream_binary "
                  f"of each file on one device and on the mesh == recon ({', '.join(f'{x:.3f}' for x in decodes)} s); "
                  "coefficients coded on the card (rle_pack, two launches a write) and decoded there (rle_unpack, one "
                  "launch a decode)", flush=True)
    return {"rle_pack": rle_launches, "rle_unpack": unpack_launches}


def _dryrun_launches(summary: dict) -> dict:
    """The kernel launches ``dryrun_multichip`` makes, from its summary.  Per
    feature set: one single-device encode, one mesh encode and one mesh
    decode.  A full search runs once per inter candidate (each frame off a
    GOP opener, promoted or not) and, under two-pass, again per inter frame;
    its winners' fetch follows each search but for the whole-pel kernel,
    which keeps their pixels.  Fast ME (never with two-pass there) runs its
    chain's passes and one confirm read and one fetch per inter step.  The
    decode fetches once per inter frame.  Each intra frame is one search
    and one reconstruction in each encode (per pass under two-pass) and one
    reconstruction in the decode; each frame step of an encode is one
    select and one dequantization, each decoded frame one.  On the mesh each
    is once per tile."""
    out: dict = {}

    def add(name: str, n: int) -> None:
        if n:
            out[name] = out.get(name, 0) + n

    for s in summary.values():
        cfg, (_, ntile), types = s["cfg"], s["mesh"], s["frame_types"]
        inter = types.count(1)
        steps = sum(1 for i in range(cfg.frames) if i % cfg.intra_dur) + (inter if cfg.two_pass else 0)
        suffix = ("_fme" if cfg.fme_enable else "") + ("_vbs" if cfg.vbs_enable else "")
        if cfg.fast_me:
            _require(not cfg.two_pass, "dryrun: the count of a two-pass fast-ME case needs pass 1's passes")
            single, mesh = s["fast_me_passes"]
            add("rowscan_pass", sum(single) + ntile * sum(mesh))
            add("window_fetch", (1 + ntile) * steps)
            add("fast_confirm", (1 + ntile) * steps)
            add("pred_fetch" + suffix, (1 + ntile) * steps)
        else:
            add("full_search" + suffix, (1 + ntile) * steps)
            if suffix:
                add("pred_fetch" + suffix, (1 + ntile) * steps)
        add("pred_fetch" + suffix, ntile * inter)
        # intra frames: searched and reconstructed in each encode (in both passes of two-pass), reconstructed in
        # the mesh decode; every encode step (``steps`` inter, the intra frames) one select and one recon, every
        # decoded frame one recon
        intra = types.count(0)
        add("intra_recon", (1 + ntile) * intra * (2 if cfg.two_pass else 1) + ntile * intra)
        add("intra_search", (1 + ntile) * intra * (2 if cfg.two_pass else 1))
        enc_steps = steps + intra * (2 if cfg.two_pass else 1)
        add("transform_select", (1 + ntile) * enc_steps)
        add("residual_recon", (1 + ntile) * enc_steps + ntile * len(types))
    return out


def _ssim_phase(dev, clip: np.ndarray, recon: np.ndarray) -> None:
    """``metrics.ssim_frames`` on the card against the host ``metrics.ssim``,
    frame by frame, on ``[main]``'s sources and reconstructions: within
    1e-6, with both times (the device call's includes the upload of both
    clips, the 16 results' copy back and a synchronisation)."""
    t0 = time.perf_counter()
    host = [metrics.ssim(a, b) for a, b in zip(clip, recon)]
    host_s = time.perf_counter() - t0
    metrics.ssim_frames(clip[:2], recon[:2], device=dev)  # warm: allocator and kernels' first launch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = metrics.ssim_frames(clip, recon, device=dev)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(host))))
    _require(len(got) == len(recon) and err <= 1e-6, f"[ssim] the device SSIM differs from the host's by {err}")
    print(f"[ssim] 720p {len(recon)} frames: device ssim_frames {dev_s:.4f} s in one call, host ssim "
          f"{host_s:.4f} s in a loop ({host_s / len(recon):.4f} s a frame); largest difference {err:.3e} (<= 1e-6), "
          f"mean SSIM {np.mean(got):.6f}", flush=True)


def _cli_phase(clip: np.ndarray, main_run: dict) -> None:
    """The command line on the card, each run's launches counted from 0 just
    before it.  Run A: ``[main]``'s config on a 4:2:0 file of the clip's
    frames with seeded chroma, with the binary container; its
    reconstruction file must be ``[main]``'s reconstructions, and its
    launches ``[main]``'s encode's plus one decode's fetches for each of its
    two decodes (binary and text).  Run B: the command line's defaults (CIF,
    21 frames, fast ME + VBS + FME, sr 16) with rate control measured on the
    card, two-pass, the binary container and the VBS overlay; its launches
    must be one ``window_fetch``, one ``fast_confirm`` and one ``pred_fetch_fme_vbs`` per fast-ME
    step (the rate tables' 12 QPs x 2 inter frames, then two passes of 20),
    ``rowscan_pass`` once per pass of their chains, one fetch per inter
    frame for each decode, and no other kernel; every file it writes must
    equal, byte for byte, what the same arguments write with ``--device
    cpu`` (the kernels' plain versions).  Both in this process; each must
    exit 0 with its decoded file equal to its reconstruction file.  Run C,
    ``python3 -m streamoptima_tpu_torch --synthetic --frames 2`` in a
    process of its own, covers the module's entry point."""
    rng = np.random.default_rng(420)
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        src = d / "clip420.yuv"
        with open(src, "wb") as f:
            for fr in clip:
                f.write(fr.tobytes())
                f.write(rng.integers(0, 256, H * W // 2, dtype=np.uint8).tobytes())

        def outputs(tag: str) -> list:
            return ["--mv-file", str(d / f"{tag}mv.txt"), "--residual-file", str(d / f"{tag}res.txt"), "--out",
                    str(d / f"{tag}dec.yuv"), "--recon-out", str(d / f"{tag}rec.yuv"), "--binary", str(d / f"{tag}.sob")]

        def closed(tag: str) -> None:
            _require((d / f"{tag}dec.yuv").read_bytes() == (d / f"{tag}rec.yuv").read_bytes(),
                     f"[cli] run {tag.upper()}: decoded != recon")

        _zero_counts()
        t0 = time.perf_counter()
        rc_a = cli_main(["--input", str(src), "--height", str(H), "--width", str(W), "--frames", str(FRAMES),
                         "--search-range", str(SR), "--qp", str(QP), "--intra-dur", str(INTRA_DUR), "--no-fast-me",
                         "--no-fme", "--no-vbs"] + outputs("a"))
        a_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}
        # the encode's intra frames, then each decode's; the encode's frame steps, then each decode's frames
        want = {"full_search": main_run["launches"]["full_search"], "pred_fetch": 2 * main_run["n_inter"],
                "intra_recon": 3 * (FRAMES // INTRA_DUR), "intra_search": FRAMES // INTRA_DUR,
                "transform_select": FRAMES, "residual_recon": 3 * FRAMES, "rle_unpack": 1}
        _require(rc_a == 0, f"[cli] run A exited {rc_a}")
        closed("a")
        _require((d / "arec.yuv").read_bytes() == main_run["pkg"]["reconstructed frames"].tobytes(),
                 "[cli] run A's reconstruction differs from [main]'s")
        _require(launches == want, f"[cli] run A's launches {launches}, expected {want}")
        print(f"[cli] run A, [main]'s config from a 4:2:0 file ({FRAMES} frames 720p): exit 0 in {a_s:.2f} s "
              f"({FRAMES / a_s:.2f} frames/s, encode + SSIM + text and binary streams + two decodes + files); "
              f"decoded == recon == [main]'s, byte for byte; launches {launches}", flush=True)

        n_b, h_b, w_b = 21, 288, 352
        argv_b = ["--synthetic", "--rc-flag", "1", "--target-br", "2400 kbps", "--two-pass"]
        n_steps = 12 * 2 + 2 * (n_b - 1)  # rc.measure_qp_tables' inter steps, then two passes' inter frames
        chained = []  # the passes of each fast-ME chain run B solves, read off motion.fast_chain
        chain = MO.fast_chain

        def recording(*a, **k):
            gs, passes = chain(*a, **k)
            chained.append(passes)
            return gs, passes

        _zero_counts()
        MO.fast_chain = recording
        try:
            t0 = time.perf_counter()
            rc_b = cli_main(argv_b + ["--vbs-overlay", str(d / "bov.yuv")] + outputs("b"))
            b_s = time.perf_counter() - t0
        finally:
            MO.fast_chain = chain
        launches = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}
        _require(rc_b == 0, f"[cli] run B exited {rc_b}")
        closed("b")
        _require(len(chained) == n_steps, f"[cli] run B solved {len(chained)} fast-ME chains, expected {n_steps}")
        # intra_recon: rc.measure_qp_tables' 12 x 2 intra steps, one intra frame in each pass and each decode;
        # the select: the tables' 12 x 2 intra and 12 x 2 inter steps and the two passes' frames, and the recon
        # those and each decode's frames
        want = {"rowscan_pass": sum(chained), "window_fetch": n_steps, "fast_confirm": n_steps,
                "pred_fetch_fme_vbs": n_steps + 2 * (n_b - 1), "intra_recon": 12 * 2 + 2 + 2,
                "intra_search": 12 * 2 + 2, "transform_select": 48 + 2 * n_b, "residual_recon": 48 + 4 * n_b,
                "rle_unpack": 1}
        _require(launches == want, f"[cli] run B's launches {launches}, expected {want}")
        t0 = time.perf_counter()
        rc_ref = cli_main(argv_b + ["--vbs-overlay", str(d / "cov.yuv"), "--device", "cpu"] + outputs("c"))
        ref_s = time.perf_counter() - t0
        _require(rc_ref == 0, f"[cli] run B on the CPU exited {rc_ref}")
        for name in ("mv.txt", "res.txt", "dec.yuv", "rec.yuv", ".sob", "ov.yuv"):
            _require((d / f"b{name}").read_bytes() == (d / f"c{name}").read_bytes(),
                     f"[cli] run B's {name} differs from the CPU run's")
        ov = np.fromfile(d / "bov.yuv", dtype=np.uint8)
        _require(ov.size == n_b * h_b * w_b, f"[cli] run B: the overlay holds {ov.size} bytes")
        ov = ov.reshape(n_b, h_b, w_b)
        _require(bool((ov[:, ::16, :] == 0).all() and (ov[:, :, ::16] == 0).all()),
                 "[cli] run B: the overlay's block grid is not drawn")
        print(f"[cli] run B, --synthetic --rc-flag 1 --target-br '2400 kbps' --two-pass --vbs-overlay (CIF {n_b} "
              f"frames, fast ME + VBS + FME, sr 16; tables measured on the card): exit 0 in {b_s:.2f} s "
              f"({n_b / b_s:.2f} frames/s); decoded == recon; launches {launches} ({n_steps} chains); mv.txt, "
              f"res.txt, the container, decoded, recon and overlay files == the --device cpu run's ({ref_s:.2f} s), "
              f"byte for byte; overlay {ov.shape}, block grid 0", flush=True)

        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "streamoptima_tpu_torch", "--synthetic", "--frames", "2"]
                             + outputs("m"), cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                             timeout=300)
        m_s = time.perf_counter() - t0
        _require(res.returncode == 0, f"[cli] run C exited {res.returncode}: {res.stdout[-2000:]} {res.stderr[-2000:]}")
        closed("m")
        print(f"[cli] run C, python3 -m streamoptima_tpu_torch --synthetic --frames 2 (CIF): exit 0 in {m_s:.2f} s "
              f"with its start-up; decoded == recon; its last line: {res.stdout.strip().splitlines()[-1]}", flush=True)


def main() -> None:
    # ---- phase 1: device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    smi = _smi("name,power.limit")
    max_mhz = float(_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cyc = max_mhz * 1e3  # SM cycles per ms at the maximum clock
    int_ops_per_ms = n_sm * INT32_LANES_PER_SM * cyc
    fp64_per_ms = n_sm * FP64_LANES_PER_SM * cyc
    print(f"[device] {smi} | {n_sm} SMs, max SM clock {max_mhz:.0f} MHz | torch {torch.__version__} | "
          f"cuda {torch.version.cuda}", flush=True)

    # ---- phase 2: build
    b = _build.build()
    _build.library()
    print(f"[build] {b.seconds:.1f} s ({'cached' if b.cached else 'nvcc, one process per source'}) {b.path.name}",
          flush=True)
    for line in b.log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)
    t0 = time.perf_counter()  # the host text serializer, built here so no timed phase pays for g++
    serializer = "g++ library" if native.available() else "unavailable, the byte-identical Python twin runs"
    print(f"[build] host text serializer: {serializer} ({time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- phase 3: each kernel against its plain version, on the card, at 720p
    clip = synthetic_clip(H, W, FRAMES)
    cur = torch.from_numpy(clip[1]).to(dev)
    ref = torch.from_numpy(clip[0]).to(dev)[None].contiguous()
    pairs = {
        "clip": (cur, ref),
        "black_vs_white": (torch.zeros_like(cur), torch.full_like(ref, 255)),
        "flat_ties": (torch.full_like(cur, 77), torch.full_like(ref, 77)),
        "drift": (torch.zeros_like(cur), torch.from_numpy(_drift_ramp(H, W)).to(dev)[None].contiguous()),
    }
    err_a = 0
    for name, (c, r) in pairs.items():
        got, plain = K.full_search(c, r, SR, BS_), K.full_search_plain(c, r, SR, BS_)
        torch.cuda.synchronize()
        for k in ("mv", "sad", "ok", "pred"):
            _require(torch.equal(got[k], plain[k]), f"full_search {name}: {k} differs from the plain version")
        err_a = max(err_a, _max_err((got[k], plain[k]) for k in ("mv", "sad", "pred")))
    ms_a, host_a = _time_ms(lambda: K.full_search(cur, ref, SR, BS_), 50, cyc)
    plain_ms_a, _ = _time_ms(lambda: K.full_search_plain(cur, ref, SR, BS_), 5, cyc)
    print(f"[kernel] full_search 720p sr={SR}: bit-equal (tolerance 0) on {list(pairs)}; {ms_a:.4f} ms vs "
          f"plain {plain_ms_a:.4f} ms (host enqueue {host_a:.4f} ms per call)", flush=True)

    rng = np.random.default_rng(0)
    nb = (H // BS_) * (W // BS_)
    mv_main = K.full_search(cur, ref, SR, BS_)["mv"]
    err_b = 0
    for name, mv in (("adversarial", torch.from_numpy(_adversarial_mvs(rng, nb, 3 * SR)).to(dev)),
                     ("search_winners", mv_main)):
        got, plain = K.pred_fetch(mv, ref, BS_), K.pred_fetch_plain(mv, ref, BS_)
        torch.cuda.synchronize()
        _require(torch.equal(got, plain), f"pred_fetch {name}: differs from the plain version")
        err_b = max(err_b, _max_err([(got, plain)]))
    ms_b, host_b = _time_ms(lambda: K.pred_fetch(mv_main, ref, BS_), 200, cyc)
    plain_ms_b, _ = _time_ms(lambda: K.pred_fetch_plain(mv_main, ref, BS_), 20, cyc)
    lib_b = _fetch_library(ref, mv_main)
    _require(torch.equal(lib_b()[0].to(torch.int16), K.pred_fetch(mv_main, ref, BS_)),
             "pred_fetch: differs from the library read")
    lib_ms_b, _ = _time_ms(lib_b, 200, cyc)
    print(f"[kernel] pred_fetch 720p: bit-equal (tolerance 0) on adversarial and search-winner MVs; "
          f"{ms_b:.4f} ms vs plain {plain_ms_b:.4f} ms, library (one indexing read of the references padded "
          f"beforehand) {lib_ms_b:.4f} ms (host enqueue {host_b:.4f} ms per call)", flush=True)

    # FME + VBS: the parity planes of each pair's reference, computed once
    fme_pairs = {k: (c, M.fme_parity_planes(r, wrap_row_pass=True)) for k, (c, r) in pairs.items()}
    planes = fme_pairs["clip"][1]
    err_c = 0
    fme_keys = ("mv", "sad", "ok", "sub_mv", "sub_sad", "sub_ok")
    for name, (c, p) in fme_pairs.items():
        got, plain = K.full_search_fme_vbs(c, p, SR, BS_), K.full_search_fme_vbs_plain(c, p, SR, BS_)
        torch.cuda.synchronize()
        for k in fme_keys:
            _require(torch.equal(got[k], plain[k]), f"full_search_fme_vbs {name}: {k} differs from the plain version")
        err_c = max(err_c, _max_err((got[k], plain[k]) for k in fme_keys))
    ms_c, host_c = _time_ms(lambda: K.full_search_fme_vbs(cur, planes, SR, BS_), 50, cyc)
    plain_ms_c, _ = _time_ms(lambda: K.full_search_fme_vbs_plain(cur, planes, SR, BS_), 5, cyc)
    print(f"[kernel] full_search_fme_vbs 720p sr={SR} (grid +-{2 * SR}): bit-equal (tolerance 0) on "
          f"{list(fme_pairs)}; {ms_c:.4f} ms vs plain {plain_ms_c:.4f} ms (host enqueue {host_c:.4f} ms per call)",
          flush=True)

    win = K.full_search_fme_vbs(cur, planes, SR, BS_)
    adv = _adversarial_mvs(rng, nb, 6 * SR)
    adv_q = np.stack([_adversarial_mvs(rng, nb, 6 * SR) for _ in range(4)], 1)
    adv[11], adv_q[11, 3] = (1, 1, 0), (3, -1, 0)  # case A at odd displacements
    adv[nb - 1] = (0, 0, 0)  # bottom-right block: case B
    err_d = 0
    fme_sets = (("adversarial_ABC", torch.from_numpy(adv).to(dev), torch.from_numpy(adv_q).to(dev)),
                ("search_winners", win["mv"], win["sub_mv"]))
    for name, mv, smv in fme_sets:
        got, plain = K.pred_fetch_fme_vbs(mv, smv, planes, BS_), K.pred_fetch_fme_vbs_plain(mv, smv, planes, BS_)
        torch.cuda.synchronize()
        _require(torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1]),
                 f"pred_fetch_fme_vbs {name}: differs from the plain version")
        err_d = max(err_d, _max_err(zip(got, plain)))
    ms_d, host_d = _time_ms(lambda: K.pred_fetch_fme_vbs(win["mv"], win["sub_mv"], planes, BS_), 200, cyc)
    plain_ms_d, _ = _time_ms(lambda: K.pred_fetch_fme_vbs_plain(win["mv"], win["sub_mv"], planes, BS_), 20, cyc)
    print(f"[kernel] pred_fetch_fme_vbs 720p: bit-equal (tolerance 0) on adversarial (cases A, B, C) and "
          f"search-winner MVs; {ms_d:.4f} ms vs plain {plain_ms_d:.4f} ms (host enqueue {host_d:.4f} ms per call)",
          flush=True)
    # the compat engine's reconstruction and decode: the quads' FME margin is the parent block's (K18)
    k18 = {"err": max(_check_equal(f"pred_fetch_fme_vbs quad_margin={BS_} {name}",
                                   K.pred_fetch_fme_vbs(mv, smv, planes, BS_, quad_margin=BS_),
                                   K.pred_fetch_fme_vbs_plain(mv, smv, planes, BS_, quad_margin=BS_))
                      for name, mv, smv in fme_sets)}
    k18["ms"], _ = _time_ms(lambda: K.pred_fetch_fme_vbs(win["mv"], win["sub_mv"], planes, BS_, quad_margin=BS_),
                            200, cyc)
    k18["plain_ms"], _ = _time_ms(lambda: K.pred_fetch_fme_vbs_plain(win["mv"], win["sub_mv"], planes, BS_,
                                                                     quad_margin=BS_), 20, cyc)
    print(f"[kernel] pred_fetch_fme_vbs 720p at quad_margin={BS_} (K18): bit-equal (tolerance 0) on the same MVs; "
          f"{k18['ms']:.4f} ms vs plain {k18['plain_ms']:.4f} ms", flush=True)

    # the tool matrix's modes: whole-pel VBS at one and four references, whole-pel at four, FME alone
    cur4 = torch.from_numpy(clip[4]).to(dev)
    ref4 = torch.from_numpy(clip[:4]).to(dev)  # what frame 4 of [main-nref4] would hold: frames 0-3
    pairs4 = {"clip": (cur4, ref4), "black_vs_white": (torch.zeros_like(cur4), torch.full_like(ref4, 255)),
              "flat_ties": (torch.full_like(cur4, 77), torch.full_like(ref4, 77))}
    modes = {}  # name -> this run's max error, kernel and plain times

    def hold(name: str, sets: dict, fn, plain, args, reps: int, plain_reps: int, what: str, library=None) -> None:
        """``library``: the one PyTorch call computing ``fn(*args)`` (uint8 planes), held and timed beside it."""
        err = max(_check_equal(f"{name} {k}", fn(*v), plain(*v)) for k, v in sets.items())
        ms, host = _time_ms(lambda: fn(*args), reps, cyc)
        plain_ms, _ = _time_ms(lambda: plain(*args), plain_reps, cyc)
        modes[name] = {"err": err, "ms": ms, "plain_ms": plain_ms, "lib_ms": None}
        if library is not None:
            got = fn(*args)
            _require(torch.equal(torch.stack(got if isinstance(got, tuple) else [got]), library().to(torch.int16)),
                     f"{name}: differs from the library read")
            modes[name]["lib_ms"], _ = _time_ms(library, reps, cyc)
        lib = "" if library is None else f", library {modes[name]['lib_ms']:.4f} ms"
        print(f"[kernel] {name} 720p {what}: bit-equal (tolerance 0) on {list(sets)}; {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms{lib} (host enqueue {host:.4f} ms per call)", flush=True)

    hold("full_search_vbs", {k: (c, r, SR, BS_) for k, (c, r) in pairs.items()}, K.full_search_vbs,
         K.full_search_vbs_plain, (cur, ref, SR, BS_), 50, 5, f"sr={SR}, one reference")
    # [main-intra1]'s range: 33^2 candidates, 297 groups of four, ten rounds of a macroblock's 32 lanes
    hold("full_search_vbs sr=16", {k: (c, r, 16, BS_) for k, (c, r) in pairs.items()}, K.full_search_vbs,
         K.full_search_vbs_plain, (cur, ref, 16, BS_), 20, 2, "sr=16, one reference")
    hold("full_search_vbs nref=4", {k: (c, r, SR, BS_) for k, (c, r) in pairs4.items()}, K.full_search_vbs,
         K.full_search_vbs_plain, (cur4, ref4, SR, BS_), 50, 3, f"sr={SR}, four references")
    hold("full_search nref=4", {k: (c, r, SR, BS_) for k, (c, r) in pairs4.items()}, K.full_search,
         K.full_search_plain, (cur4, ref4, SR, BS_), 50, 3, f"sr={SR}, four references")
    hold("full_search_fme", {k: (c, p, SR, BS_) for k, (c, p) in fme_pairs.items()}, K.full_search_fme,
         K.full_search_fme_plain, (cur, planes, SR, BS_), 50, 5, f"sr={SR} (grid +-{2 * SR}), block winners only")
    win_v = K.full_search_vbs(cur, ref, SR, BS_)
    adv_w = _adversarial_mvs(rng, nb, 3 * SR)
    adv_wq = np.stack([_adversarial_mvs(rng, nb, 3 * SR) for _ in range(4)], 1)
    hold("pred_fetch_vbs", {"adversarial": (torch.from_numpy(adv_w).to(dev), torch.from_numpy(adv_wq).to(dev), ref,
                                            BS_),
                            "search_winners": (win_v["mv"], win_v["sub_mv"], ref, BS_)},
         K.pred_fetch_vbs, K.pred_fetch_vbs_plain, (win_v["mv"], win_v["sub_mv"], ref, BS_), 200, 20,
         "whole-pel with the quad plane, adversarial and search-winner MVs",
         library=_fetch_library(ref, win_v["mv"], win_v["sub_mv"]))
    # [main-nref4]'s decode: the fetch over the four-reference FIFO
    win4 = K.full_search(cur4, ref4, SR, BS_)["mv"]
    adv4 = _adversarial_mvs(rng, nb, 3 * SR)
    adv4[:, 2] = rng.integers(0, 4, nb)  # reference indices 0-3
    hold("pred_fetch nref=4", {"adversarial": (torch.from_numpy(adv4).to(dev), ref4, BS_),
                               "search_winners": (win4, ref4, BS_)},
         K.pred_fetch, K.pred_fetch_plain, (win4, ref4, BS_), 200, 20,
         "four references, adversarial MVs over references 0-3 and search-winner MVs",
         library=_fetch_library(ref4, win4))
    win_f = K.full_search_fme(cur, planes, SR, BS_)
    hold("pred_fetch_fme", {"adversarial_ABC": (torch.from_numpy(adv).to(dev), planes, BS_),
                            "search_winners": (win_f["mv"], planes, BS_)},
         K.pred_fetch_fme, K.pred_fetch_fme_plain, (win_f["mv"], planes, BS_), 200, 20,
         "FME without the quad plane, adversarial (cases A, B, C) and search-winner MVs")

    # fast ME: the chain pass and the region gather, FME (the planes above) and whole-pel (the references)
    S = H // BS_
    wild = rng.integers(-9, 10, (S, 3)).astype(np.int32)
    wild[:, 2] = 0
    wild[1], wild[2], wild[3] = (-3, -5, 0), (5001, -4001, 0), (-2 * W - 1, 2 * H + 1, 0)
    chain = {}  # mode -> converged seeds, MVPs and confirm origins on the clip, with the kernels' times
    for fme, sets in ((True, fme_pairs), (False, pairs)):
        mode = "FME" if fme else "whole-pel"
        solver = TorchCodec(_cfg(**(FAST_VBS_FME if fme else FAST)), device=dev)
        err_e = 0
        for name, (c, p) in sets.items():
            # a cold solve by the engine: the converged MVPs, and the seeds they hold (each row's first)
            solved, npass = solver.motion.fast_search(c, blockify(c, BS_).to(torch.int32), p, None)
            g_fin = solved["g_next"]
            conv_seeds = g_fin.reshape(S, W // BS_, 3)[:, 0].contiguous()
            if name == "clip":
                chain[fme] = {"seeds": conv_seeds, "g": g_fin, "passes": npass}
            for sname, seeds in (("zero", torch.zeros_like(conv_seeds)), ("random", torch.from_numpy(wild).to(dev)),
                                 ("converged", conv_seeds)):
                got, plain = K.rowscan_pass(c, p, seeds, BS_, fme), K.rowscan_pass_plain(c, p, seeds, BS_, fme)
                torch.cuda.synchronize()
                _require(torch.equal(got, plain), f"rowscan_pass {mode} {name} {sname} seeds: differs from the plain "
                                                  f"version")
                err_e = max(err_e, _max_err([(got, plain)]))
                if name == "drift" and sname == "zero":  # the MVPs did drift, one step a column, over many columns
                    steps = (plain[0, 1:, :2] - plain[0, :-1, :2]).abs()
                    _require(int((steps == 1).all(dim=1).sum()) >= 20, f"rowscan_pass {mode}: the drift clip drifted "
                                                                        f"{plain[0, :, :2].tolist()}")
        c, p = sets["clip"]
        ch = chain[fme]
        ch["err"] = err_e
        ch["ms"], host_e = _time_ms(lambda: K.rowscan_pass(c, p, ch["seeds"], BS_, fme), 50, cyc)
        ch["plain_ms"], _ = _time_ms(lambda: K.rowscan_pass_plain(c, p, ch["seeds"], BS_, fme), 3, cyc)
        print(f"[kernel] rowscan_pass 720p {mode} (S={S}, L={W // BS_}): bit-equal (tolerance 0) on {list(sets)} "
              f"from zero, random and converged seeds; {ch['ms']:.4f} ms vs plain {ch['plain_ms']:.4f} ms (host "
              f"enqueue {host_e:.4f} ms per call); a cold start on the clip converges in {ch['passes']} passes",
              flush=True)

        flat = p.reshape(-1, H, W)
        ch["flat"] = flat
        # the confirm pass's origins
        ch["by0"], ch["bx0"] = FM.region_base(ch["g"], solver.motion.by, solver.motion.bx, fme)
        adv_y = rng.integers(-40, H + 40, nb).astype(np.int32)
        adv_x = rng.integers(-40, W + 40, nb).astype(np.int32)
        adv_y[:6] = (-5, H - 3, 7, 9, -(10**6), 2**30)  # straddling each edge, odd, far outside
        adv_x[:6] = (11, 13, -7, W - 5, 10**6, -(2**30))
        wsets = {"adversarial": (torch.from_numpy(adv_y).to(dev), torch.from_numpy(adv_x).to(dev)),
                 "confirm_origins": (ch["by0"], ch["bx0"])}
        wf = _hold_window(mode, flat, wsets, "confirm_origins", cyc)
        ch.update(werr=wf["err"], wms=wf["ms"], wplain_ms=wf["plain_ms"], wlib_ms=wf["lib_ms"],
                  wfloor_ms=wf["floor_ms"])
        g_wild = torch.from_numpy(_adversarial_mvs(rng, nb, 3 * W)).to(dev)
        ch["confirm"] = _hold_confirm(mode, solver, sets, ch["g"], g_wild, cyc, int_ops_per_ms)
        print(f"[kernel] window_fetch 720p {mode} ({nb}, {flat.shape[0]}, {BS_ + 2}, {BS_ + 2}): bit-equal (tolerance "
              f"0) on adversarial and converged confirm origins, to the plain version and the library read; "
              f"{wf['ms']:.4f} ms vs plain {wf['plain_ms']:.4f} ms, library (one indexing read of planes padded "
              f"beforehand) {wf['lib_ms']:.4f} ms, a bare write of the output {wf['floor_ms']:.4f} ms (host enqueue "
              f"{wf['host_ms']:.4f} ms per call)", flush=True)
        if fme:  # the confirm at four references (P = 16), and planes whose rows and base are not word-aligned
            flat4 = M.fme_parity_planes(ref4, wrap_row_pass=True).reshape(-1, H, W)
            ch["nref4"] = _hold_window("FME nref=4", flat4, wsets, "confirm_origins", cyc)
            ch["nref4"]["bytes"] = (_window_bytes_read(flat4, ch["by0"], ch["bx0"], BS_ + 2) + nb * 8
                                    + nb * flat4.shape[0] * (BS_ + 2) ** 2)
            wu = W - 3  # an odd width; the planes start one byte past the allocation's 16-byte alignment
            big = torch.from_numpy(rng.integers(0, 256, 4 * H * wu + 1, dtype=np.uint8)).to(dev)
            flat_u = big[1:].view(4, H, wu)
            ch["unaligned"] = _hold_window(f"FME w={wu} base+1", flat_u, wsets, "confirm_origins", cyc)
            ch["unaligned"]["bytes"] = (_window_bytes_read(flat_u, ch["by0"], ch["bx0"], BS_ + 2) + nb * 8
                                        + nb * flat_u.shape[0] * (BS_ + 2) ** 2)
            for label, r in (("four references", ch["nref4"]), (f"w={wu}, base 1 byte past 16-byte alignment",
                                                                 ch["unaligned"])):
                print(f"[kernel] window_fetch 720p FME, {label}: bit-equal (tolerance 0) on adversarial and "
                      f"converged confirm origins, to the plain version and the library read; {r['ms']:.4f} ms vs "
                      f"plain {r['plain_ms']:.4f} ms, library {r['lib_ms']:.4f} ms, a bare write of the output "
                      f"{r['floor_ms']:.4f} ms", flush=True)

    # band inputs: each mode on the three tiles of a tile-3 split (240 rows), a halo of sr + 1 rows of each
    # neighbour and zero rows past the frame's edges, as the mesh paths call them
    h_t, halo = H // N_TILES, SR + 1
    nb_t = nb // N_TILES
    band_pairs = {name: [] for name in ("clip", "flat_ties")}  # per tile: cur, band, its parity planes, band kwargs
    for name in band_pairs:
        c, r = pairs[name]
        for t in range(N_TILES):
            band = _halo_band(list(r[0].split(h_t)), t, halo, dev)[None].contiguous()
            band_pairs[name].append((c[t * h_t:(t + 1) * h_t].contiguous(), band,
                                     M.fme_parity_planes(band, wrap_row_pass=True),
                                     {"band_row0": halo, "g_row0": t * h_t, "grid": (H, W)}))
    bands = band_pairs["clip"]
    band = {}  # mode -> this run's max error, times per launch, and the bound's bytes and operations (three tiles)

    def hold_band(name: str, sets: dict, reps: int, plain_reps: int, nbytes: float, ops: float, what: str) -> None:
        """``sets``: input set -> per tile, the call's positional inputs and band kwargs."""
        fn, plain = KERNELS[name], getattr(K, f"{name}_plain")
        err = max(_check_equal(f"{name} band {k} tile {t}", fn(*a, **kw), plain(*a, **kw))
                  for k, calls in sets.items() for t, (a, kw) in enumerate(calls))
        calls = next(iter(sets.values()))
        ms, host = _time_ms(lambda: [fn(*a, **kw) for a, kw in calls], reps, cyc)
        plain_ms, _ = _time_ms(lambda: [plain(*a, **kw) for a, kw in calls], plain_reps, cyc)
        band[name] = {"err": err, "ms": ms / N_TILES, "plain_ms": plain_ms / N_TILES, "frame_ms": ms,
                      "bytes": nbytes / N_TILES, "ops": ops / N_TILES}
        print(f"[band] {name} 720p, {N_TILES} tiles of {h_t} rows, halo {halo} ({what}): bit-equal (tolerance 0) on "
              f"{list(sets)}; {ms:.4f} ms for the three launches of a frame ({ms / N_TILES:.4f} per launch) vs plain "
              f"{plain_ms:.4f} ms (host enqueue {host / N_TILES:.4f} ms per launch)", flush=True)

    out_v_t = nb_t * 5 * (12 + 4 + 1)
    for name in ("full_search", "full_search_vbs", "full_search_fme", "full_search_fme_vbs"):
        _, _, vbs, fme = BAND_MODES[name]
        sets = {k: [((c, p if fme else b, SR, BS_), kw) for c, b, p, kw in v] for k, v in band_pairs.items()}
        nbytes = sum(c.numel() + (p if fme else b).numel() for c, b, p, _ in bands) + N_TILES * (
            out_v_t if vbs else nb_t * 17 + (0 if fme else 2 * h_t * W))
        ops = sum(_search_ops(h_t, W, 1, fme, dev, vbs=vbs, g_row0=t * h_t, frame_h=H) for t in range(N_TILES))
        hold_band(name, sets, 50, 5, nbytes, ops, f"sr={SR}" + (" half-pel" if fme else "") + (" VBS" if vbs else ""))
    # the fetches: the band search's winners, and adversarial MVs whose windows reach into and past the halo
    winners = {False: [K.full_search_vbs(c, b, SR, BS_, **kw) for c, b, _, kw in bands],
               True: [K.full_search_fme_vbs(c, p, SR, BS_, **kw) for c, _, p, kw in bands]}
    for name in ("pred_fetch", "pred_fetch_vbs", "pred_fetch_fme", "pred_fetch_fme_vbs"):
        _, _, vbs, fme = BAND_MODES[name]
        reach = (2 if fme else 1) * 3 * halo
        adv_sets, win_sets, nbytes = [], [], 0
        for t, (c, b, p, kw) in enumerate(bands):
            refs_t = p if fme else b
            mv_a = _adversarial_mvs(rng, nb, reach)[:nb_t]
            mv_a[:, 1] = rng.integers(-reach, reach + 1, nb_t)
            smv_a = np.stack([_adversarial_mvs(rng, nb, reach)[:nb_t] for _ in range(4)], 1)
            mv_a, smv_a = torch.from_numpy(mv_a).to(dev), torch.from_numpy(smv_a).to(dev)
            wn = winners[fme][t]
            adv_sets.append(((mv_a, smv_a, refs_t, BS_) if vbs else (mv_a, refs_t, BS_), kw))
            win_sets.append(((wn["mv"], wn["sub_mv"], refs_t, BS_) if vbs else (wn["mv"], refs_t, BS_), kw))
            nbytes += nb_t * (5 if vbs else 1) * 12 + (4 if vbs else 2) * h_t * W + _fetch_bytes_read(
                wn["mv"], refs_t, wn["sub_mv"] if vbs else None, fme, **kw)
        hold_band(name, {"search_winners": win_sets, "adversarial": adv_sets}, 200, 20, nbytes, 0,
                  ("half-pel, cases A, B, C" if fme else "whole-pel") + (" with the quad plane" if vbs else ""))


    # fast ME on a mesh tile: rowscan_pass with the tile's rows of cur and the whole frame's planes at the
    # tile's frame row, as the fast-ME mesh paths call it, and window_fetch at the tile's confirm origins
    S_t, L = h_t // BS_, W // BS_
    tiles = {}  # mode -> this run's errors, times per launch and bound inputs, summed over the three tiles
    for fme, sets in ((True, fme_pairs), (False, pairs)):
        mode = "FME" if fme else "whole-pel"
        tcfg = _cfg(**(FAST_VBS_FME if fme else FAST))
        engines = [TorchCodec(tcfg, device=dev, rows=(t * h_t, (t + 1) * h_t)) for t in range(N_TILES)]
        err = 0
        for name, (c, p) in sets.items():
            curs = [c[t * h_t:(t + 1) * h_t] for t in range(N_TILES)]
            # a cold solve of the frame
            gs, npass = MO.fast_chain([e.motion for e in engines], curs, [p] * N_TILES, [None] * N_TILES)
            conv = [g.reshape(S_t, L, 3)[:, 0].contiguous() for g in gs]
            if name == "clip":
                tiles[fme] = {"curs": curs, "p": p, "gs": gs, "seeds": conv, "passes": npass}
            for t in range(N_TILES):
                wild_t = rng.integers(-9, 10, (S_t, 3)).astype(np.int32)
                wild_t[:, 2] = 0
                wild_t[0], wild_t[1] = (0, -h_t - 7, 0), (-3, -5, 0)  # into the tile above; negative and odd
                wild_t[2], wild_t[3] = (5001, -4001, 0), (-2 * W - 1, 2 * H + 1, 0)  # far outside
                kw = {"g_row0": t * h_t, "grid": (H, W)}
                for sname, seeds in (("zero", torch.zeros_like(conv[t])), ("random", torch.from_numpy(wild_t).to(dev)),
                                     ("converged", conv[t])):
                    err = max(err, _check_equal(f"rowscan_pass tile {t} {mode} {name} {sname} seeds",
                                                K.rowscan_pass(curs[t], p, seeds, BS_, fme, **kw),
                                                K.rowscan_pass_plain(curs[t], p, seeds, BS_, fme, **kw)))
        tl = tiles[fme]
        curs, p, flat = tl["curs"], tl["p"], tl["p"].reshape(-1, H, W)
        kws = [{"g_row0": t * h_t, "grid": (H, W)} for t in range(N_TILES)]
        ms = [_time_ms(lambda: K.rowscan_pass(curs[t], p, tl["seeds"][t], BS_, fme, **kws[t]), 50, cyc)[0]
              for t in range(N_TILES)]
        plain_ms = [_time_ms(lambda: K.rowscan_pass_plain(curs[t], p, tl["seeds"][t], BS_, fme, **kws[t]), 2, cyc)[0]
                    for t in range(N_TILES)]
        pass_ms, _ = _time_ms(lambda: [K.rowscan_pass(curs[t], p, tl["seeds"][t], BS_, fme, **kws[t])
                                       for t in range(N_TILES)], 20, cyc)
        origins = [FM.region_base(g, e.motion.by + e.g_row0, e.motion.bx, fme) for g, e in zip(tl["gs"], engines)]
        wt = [_hold_window(f"tile {t} {mode}", flat, {"confirm_origins": origins[t]}, "confirm_origins", cyc)
              for t in range(N_TILES)]
        werr, wms = max(x["err"] for x in wt), [x["ms"] for x in wt]
        wplain, wlib, wfloor = [x["plain_ms"] for x in wt], [x["lib_ms"] for x in wt], [x["floor_ms"] for x in wt]
        wbytes = [_window_bytes_read(flat, *origins[t], BS_ + 2) for t in range(N_TILES)]
        tl.update(err=err, ms=float(np.mean(ms)), plain_ms=float(np.mean(plain_ms)), pass_ms=pass_ms,
                  werr=werr, wms=float(np.mean(wms)), wplain_ms=float(np.mean(wplain)), wlib_ms=float(np.mean(wlib)),
                  wfloor_ms=float(np.mean(wfloor)),
                  # per launch, the mean over the tiles: the tile's rows of cur, the plane bytes its windows read at
                  # the converged chain, seeds and MVs; the candidates its K7 bounds make valid there
                  bytes=h_t * W + float(np.mean(wbytes)) + S_t * 12 + nb_t * 12,
                  ops=float(np.mean([_chain_ops(g, 1, fme, dev, h_t, t * h_t) for t, g in enumerate(tl["gs"])])),
                  wbytes=float(np.mean(wbytes)) + nb_t * 8 + nb_t * flat.shape[0] * (BS_ + 2) ** 2)
        print(f"[tile] rowscan_pass 720p {mode}, {N_TILES} tiles of {h_t} rows (S={S_t}, L={L}), whole-frame planes: "
              f"bit-equal (tolerance 0) on {list(sets)} from zero, random and converged seeds; per launch "
              f"{', '.join(f'{x:.4f}' for x in ms)} ms (tiles 0-2) vs plain {tl['plain_ms']:.4f} ms; a mesh pass's "
              f"three launches {pass_ms:.4f} ms; a cold start on the clip converges in {tl['passes']} passes", flush=True)
        print(f"[tile] window_fetch 720p {mode} at the tiles' confirm origins ({nb_t}, {flat.shape[0]}, {BS_ + 2}, "
              f"{BS_ + 2}): bit-equal (tolerance 0) to the plain version and the library read; per launch "
              f"{', '.join(f'{x:.4f}' for x in wms)} ms vs plain {tl['wplain_ms']:.4f} ms, library "
              f"{tl['wlib_ms']:.4f} ms, a bare write of the output {tl['wfloor_ms']:.4f} ms", flush=True)

    x = rng.integers(-255, 256, (nb, 16, 16)).astype(np.int32)
    x[0], x[1] = 255, -255
    t = rng.integers(-12288, 12289, (nb, 16, 16)).astype(np.int32)
    t[0], t[1] = 12288, -12288
    for f, a in ((T.dct2_int, x), (T.idct2_int, t)):
        _require(torch.equal(f(torch.from_numpy(a).to(dev)).cpu(), f(torch.from_numpy(a))),
                 f"{f.__name__} on the card differs from the CPU port")
    print(f"[transform] dct2_int / idct2_int on the card bit-equal to the CPU port ({nb} blocks, extremes)",
          flush=True)
    dct_row = _dct_phase(dev, cyc, fp64_per_ms)
    # the arguments each config's intra and inter steps pass the residual-coding wrappers, read off them
    calls = {label: _step_calls(_cfg(**extra), clip, dev) for label, extra in (
        ("main", {}), ("main-fast-vbs-fme", FAST_VBS_FME), ("main-intra1", TOOLS["main-intra1"]))}
    intra_row = _intra_phase(dev, calls, cyc)
    residual_rows = _residual_phases(dev, calls, cyc, int_ops_per_ms)

    small = synthetic_clip(64, 96, 6, seed=3)
    small_cfgs = {"whole-pel": {}, "VBS + FME": VBS_FME, "fast ME": FAST, "fast ME + VBS + FME": FAST_VBS_FME,
                  **TOOLS, "nref3 fast ME + VBS + FME": {**FAST_VBS_FME, "n_ref_frames": 3},
                  "intra1 sr=8": {"intra_mode": 1}, "pm2 fast ME + VBS + FME": {**FAST_VBS_FME, "parallel_mode": 2},
                  "pm3 fast ME": {**FAST, "parallel_mode": 3}}
    for name, extra in small_cfgs.items():
        a = TorchCodec(_cfg(64, 96, 6, **extra), small, device=dev).encode(package=False)
        b_ = TorchCodec(_cfg(64, 96, 6, **extra), small, device="cpu").encode(package=False)
        _require(np.array_equal(a["reconstructed frames"], b_["reconstructed frames"]),
                 f"small encode {name} on the card differs from the CPU port")
        _require(a.get("fast_me_passes") == b_.get("fast_me_passes"), f"small encode {name}: passes per frame differ")
        for fa, fb in zip(a["per_frame"], b_["per_frame"]):
            for k in ("mv", "split", "sub_mv", "qtc_full", "qtc_quads"):
                _require(torch.equal(fa[k].cpu(), fb[k]), f"small encode {name}: {k} differs from the CPU port")
    # rate control on one device, and fast ME on a (2, 2) mesh of the card, against the CPU port
    small_rc = {"rc": {"rc_flag": 1}, "promotion": {"rc_flag": 2, "intra_thresh": 1400},
                "two-pass VBS + FME": {"rc_flag": 1, "two_pass": True, **VBS_FME},
                "ROI fast ME + VBS": {"roi_qp_map": np.arange(24) % 5 - 2, **FAST, "vbs_enable": True}}
    small_tables = [[9000, 4000, 2000, 1100, 800, 600, 450, 350, 280, 230, 200, 180],
                    [8000, 3500, 1800, 1000, 700, 500, 400, 300, 250, 210, 190, 170]]
    for name, extra in small_rc.items():
        cfg_s = _cfg(64, 96, 6, target_br="60 kbps", qp_rate_tables=small_tables, **extra)
        a = TorchCodec(cfg_s, small, device=dev).encode(package=False)
        b_ = TorchCodec(cfg_s, small, device="cpu").encode(package=False)
        for k in ("frame_type_seq", "Qp_per_row_per_frame", "residual size per frame"):
            _require(a[k] == b_[k], f"small encode {name}: {k} differs from the CPU port")
        _require(np.array_equal(a["reconstructed frames"], b_["reconstructed frames"]),
                 f"small encode {name} on the card differs from the CPU port")
    for name, extra in (("mesh fast ME", FAST), ("mesh fast ME + VBS + FME", FAST_VBS_FME)):
        cfg_s = _cfg(64, 96, 6, **dict(extra, search_range=4))
        mesh_s = make_mesh(cfg_s, devices=[dev] * 4, tile=2)
        a = ShardedCodec(cfg_s, mesh_s, small).encode(package=False)
        b_ = TorchCodec(cfg_s, small, device="cpu").encode(package=False)
        _require(np.array_equal(a["reconstructed frames"], b_["reconstructed frames"]),
                 f"small {name} on the card differs from the CPU port")
        for fa, fb in zip(a["per_frame"], b_["per_frame"]):
            for k in ("mv", "split", "sub_mv", "qtc_full", "qtc_quads"):
                _require(torch.equal(fa[k].cpu(), fb[k]), f"small {name}: {k} differs from the CPU port")
    print(f"[reference] 64x96 6-frame encodes on the card equal the CPU port (held to the JAX engine by the CPU "
          f"tests): {list(small_cfgs) + list(small_rc)}, and on a (2, 2) mesh of the card fast ME and fast ME + "
          f"VBS + FME", flush=True)

    # ---- phase 4: the main paths, each with its own launch counts (every kernel's)
    n8 = 8 - 8 // INTRA_DUR  # inter frames of an 8-frame path
    # full search: one search per inter frame (the whole-pel kernel keeps the winners' pixels, the others'
    # come from one fetch), and one fetch per inter frame in decode
    whole = _drive("main", {}, clip, dev, full_search=N_INTER, pred_fetch=N_INTER)
    vf = _drive("main-vbs-fme", VBS_FME, clip, dev, full_search_fme_vbs=N_INTER, pred_fetch_fme_vbs=2 * N_INTER)
    _require(sum(int(o["split"].sum()) for o in vf["pkg"]["per_frame"]) > 0, "the VBS + FME path split no block")
    # fast ME: the chain's passes, one confirm (its regions' read and one fast_confirm) and one winner fetch per
    # inter frame; decode: one fetch
    fast = {"main-fast-vbs-fme": _drive("main-fast-vbs-fme", FAST_VBS_FME, clip, dev, rowscan_pass="passes",
                                        window_fetch=N_INTER, fast_confirm=N_INTER, pred_fetch_fme_vbs=2 * N_INTER),
            "main-fast": _drive("main-fast", FAST, clip, dev, rowscan_pass="passes", window_fetch=N_INTER,
                                fast_confirm=N_INTER, pred_fetch=2 * N_INTER)}
    _require(sum(int(o["split"].sum()) for o in fast["main-fast-vbs-fme"]["pkg"]["per_frame"]) > 0,
             "the fast-ME VBS + FME path split no block")
    rle_row = _rle_phase(dev, fast["main-fast-vbs-fme"]["pkg"], cyc)
    unpack_row = _unpack_phase(dev, fast["main-fast-vbs-fme"]["codec"], cyc)
    tools = {
        "main-vbs": _drive("main-vbs", TOOLS["main-vbs"], clip, dev, full_search_vbs=N_INTER,
                           pred_fetch_vbs=2 * N_INTER),
        "main-nref4": _drive("main-nref4", TOOLS["main-nref4"], clip, dev, full_search=N_INTER, pred_fetch=N_INTER),
        "main-fme": _drive("main-fme", TOOLS["main-fme"], clip, dev, 8, full_search_fme=n8, pred_fetch_fme=2 * n8),
        "main-fast-vbs": _drive("main-fast-vbs", TOOLS["main-fast-vbs"], clip, dev, 8, rowscan_pass="passes",
                                window_fetch=n8, fast_confirm=n8, pred_fetch_vbs=2 * n8),
        "main-fast-fme": _drive("main-fast-fme", TOOLS["main-fast-fme"], clip, dev, 8, rowscan_pass="passes",
                                window_fetch=n8, fast_confirm=n8, pred_fetch_fme=2 * n8),
        "main-intra1": _drive("main-intra1", TOOLS["main-intra1"], clip, dev, 8, full_search_vbs=n8,
                              pred_fetch_vbs=2 * n8),
        # mode 1: every frame is an inter frame against the all-128 plane
        "main-pm1": _drive("main-pm1", TOOLS["main-pm1"], clip, dev, 8, full_search=8, pred_fetch=8),
        # mode 2: one confirm read at zero MVPs per inter frame, no chain
        "main-pm2": _drive("main-pm2", TOOLS["main-pm2"], clip, dev, 8, window_fetch=n8, fast_confirm=n8,
                           pred_fetch=2 * n8),
        "main-pm3": _drive("main-pm3", TOOLS["main-pm3"], clip, dev, 8, full_search=n8, pred_fetch=n8),
    }
    for label in ("main-vbs", "main-fast-vbs", "main-intra1"):
        _require(sum(int(o["split"].sum()) for o in tools[label]["pkg"]["per_frame"]) > 0, f"{label} split no block")
    # the mesh: three band searches per inter frame (and, but for the whole-pel kernel that keeps its
    # winners' pixels, three winner fetches), three band fetches per inter frame in decode
    tiled = {"n": N_TILES * N_INTER, "n8": N_TILES * n8}
    meshes = {
        "mesh": ({}, FRAMES, {"full_search": tiled["n"], "pred_fetch": tiled["n"]}),
        "mesh-vbs-fme": (VBS_FME, FRAMES, {"full_search_fme_vbs": tiled["n"], "pred_fetch_fme_vbs": 2 * tiled["n"]}),
        "mesh-vbs": (TOOLS["main-vbs"], 8, {"full_search_vbs": tiled["n8"], "pred_fetch_vbs": 2 * tiled["n8"]}),
        "mesh-fme": (TOOLS["main-fme"], 8, {"full_search_fme": tiled["n8"], "pred_fetch_fme": 2 * tiled["n8"]}),
    }
    mesh_runs = {}
    for label, (extra, frames, expected) in meshes.items():
        mesh_runs[label] = _drive(label, extra, clip, dev, frames, mesh=True, **expected)
        _check_mesh(label, extra, clip, dev, mesh_runs[label], frames)
    # fast ME on the mesh: every pass one rowscan_pass launch per tile; one confirm read and one winner
    # fetch per tile and inter frame; decode: one fetch per tile and inter frame
    mesh_fast = {
        "mesh-fast-vbs-fme": (FAST_VBS_FME, FRAMES, {"rowscan_pass": "passes", "window_fetch": tiled["n"],
                                                     "fast_confirm": tiled["n"], "pred_fetch_fme_vbs": 2 * tiled["n"]}),
        "mesh-fast": (FAST, 8, {"rowscan_pass": "passes", "window_fetch": tiled["n8"], "fast_confirm": tiled["n8"],
                                "pred_fetch": 2 * tiled["n8"]}),
    }
    for label, (extra, frames, expected) in mesh_fast.items():
        mesh_runs[label] = _drive(label, extra, clip, dev, frames, mesh=True, **expected)
        _check_mesh(label, extra, clip, dev, mesh_runs[label], frames)

    # rate control on one device, 8 frames: sweep.py's 720p_rc_row_qp and 720p_two_pass, an ROI map, and
    # scene-change promotion at a cut spliced in at frame 4
    clip8 = clip[:8]
    roi = np.full((H // BS_, W // BS_), 2, np.int32)
    roi[H // BS_ // 3:2 * H // BS_ // 3, W // BS_ // 3:2 * W // BS_ // 3] = -2
    rcs = {"main-rc": _drive("main-rc", RC, clip8, dev, 8, min_psnr=RC_MIN_PSNR, full_search=n8, pred_fetch=n8),
           # two passes of the clip: two searches per inter frame, one decode
           "main-two-pass": _drive("main-two-pass", {**RC, "two_pass": True}, clip8, dev, 8, min_psnr=RC_MIN_PSNR,
                                   full_search=2 * n8, pred_fetch=n8),
           "main-roi": _drive("main-roi", {"roi_qp_map": roi}, clip8, dev, 8, min_psnr=ROI_MIN_PSNR, full_search=n8,
                              pred_fetch=n8)}
    sizes = rcs["main-rc"]["pkg"]["residual size per frame"]
    thresh = 2 * max(sz for sz, ft in zip(sizes, rcs["main-rc"]["pkg"]["frame_type_seq"]) if ft == 1)
    # the cut is to unsmoothed texture: at the tables' QPs 7 and 8 the residual of one smooth texture against
    # another quantizes to almost nothing, so only a cut to noise costs more than twice an inter frame.  Frames
    # 5-7 predict the noise from frame 4's coarse reconstruction and are promoted too.
    cut = np.concatenate([clip[:4], synthetic_clip(H, W, 4, seed=7, smooth=False)])
    promote_types = [0, 1, 1, 1, 0, 0, 0, 0]
    # the search runs on every inter candidate (a promoted frame's before its promotion); decode fetches the rest
    rcs["main-rc-promote"] = _drive("main-rc-promote", {**RC, "rc_flag": 2, "intra_thresh": thresh}, cut, dev, 8,
                                    types=promote_types, min_psnr=PROMOTE_MIN_PSNR, full_search=n8,
                                    pred_fetch=promote_types.count(1))
    print(f"[main-rc-promote] intra_thresh {thresh} (twice [main-rc]'s largest inter frame): frame 4 promoted, "
          f"frame types {rcs['main-rc-promote']['pkg']['frame_type_seq']}, sizes "
          f"{rcs['main-rc-promote']['pkg']['residual size per frame']} against [main-rc]'s {sizes}", flush=True)
    _require(rcs["main-two-pass"]["pkg"]["Qp_per_row_per_frame"] != rcs["main-rc"]["pkg"]["Qp_per_row_per_frame"],
             "main-two-pass: the second pass kept the table QPs")

    # rate control on the mesh: the same configs on the six shards, each tile at its rows of the frame's QPs.
    # [mesh-rc] and [mesh-rc-promote] run 16 frames, a GOP on each data row; the promoted clip keeps its cut at
    # frame 4 and the clip's own frames 8-15, so the second GOP codes as [mesh-rc]'s does
    cut16 = np.concatenate([cut, clip[8:16]])
    promote16 = promote_types + [0] + [1] * 7
    mesh_rcs = {
        "mesh-rc": (RC, clip, FRAMES, None, RC_MIN_PSNR, {"full_search": tiled["n"], "pred_fetch": tiled["n"]}),
        "mesh-two-pass": ({**RC, "two_pass": True}, clip, 8, None, RC_MIN_PSNR,
                          {"full_search": 2 * tiled["n8"], "pred_fetch": tiled["n8"]}),
        "mesh-roi": ({"roi_qp_map": roi}, clip, 8, None, ROI_MIN_PSNR,
                     {"full_search": tiled["n8"], "pred_fetch": tiled["n8"]}),
        # every inter candidate's band search runs (a promoted frame's too); its fetch does not
        "mesh-rc-promote": ({**RC, "rc_flag": 2, "intra_thresh": thresh}, cut16, FRAMES, promote16, PROMOTE_MIN_PSNR,
                            {"full_search": N_TILES * N_INTER, "pred_fetch": N_TILES * promote16.count(1)}),
    }
    singles = {}
    for label, (extra, src, frames, types, floor, expected) in mesh_rcs.items():
        mesh_runs[label] = _drive(label, extra, src, dev, frames, mesh=True, types=types, min_psnr=floor, **expected)
        singles[label] = _check_mesh(label, extra, src, dev, mesh_runs[label], frames)
    _require(mesh_runs["mesh-rc-promote"]["pkg"]["frame_type_seq"][4] == 0, "mesh-rc-promote: frame 4 not promoted")
    _require(mesh_runs["mesh-two-pass"]["pkg"]["Qp_per_row_per_frame"]
             != mesh_runs["mesh-rc"]["pkg"]["Qp_per_row_per_frame"][:8], "mesh-two-pass: pass 2 kept the table QPs")

    # the binary container from [main] and [mesh]'s encodes (one config, one device and the mesh), and from
    # [mesh-rc]'s and its single-device twin's
    binary = _binary_phase(
        dev, {"main": (whole["codec"], mesh_runs["mesh"]["codec"], mesh_runs["mesh"]["pkg"]),
              "mesh-rc": (singles["mesh-rc"], mesh_runs["mesh-rc"]["codec"], mesh_runs["mesh-rc"]["pkg"])})
    rle_row["launches"], unpack_row["launches"] = binary["rle_pack"], binary["rle_unpack"]

    # the dry run: __graft_entry__.dryrun_multichip's six feature sets at 64x64 on an 8-shard mesh of the card
    _zero_counts()
    t0 = time.perf_counter()
    dry = dryrun_multichip(8, device=dev)
    dry_s = time.perf_counter() - t0
    dry_launches = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}
    _require(dry_launches == _dryrun_launches(dry),
             f"[dryrun] kernel launches {dry_launches}, expected {_dryrun_launches(dry)}")
    print(f"[dryrun] {len(dry)} feature sets on an 8-shard mesh of the card, bit for bit with one device, "
          f"{dry_s:.2f} s; launches {dry_launches}", flush=True)

    refs_used = {int(r) for o in tools["main-nref4"]["pkg"]["per_frame"][1:8] for r in o["mv"][:, 2].unique()}
    _require(len(refs_used) > 1, f"main-nref4: inter frames chose only reference {sorted(refs_used)}")

    _ssim_phase(dev, clip, whole["pkg"]["reconstructed frames"])
    _cli_phase(clip, whole)
    compat = _compat_phase(dev)
    times = profiling.time_steps(_cfg(), clip, warmup=1, iters=8, device=dev)
    print("[profiling] profiling.time_steps, [main]'s config at 720p (8 synchronised runs a step):\n"
          + profiling.report(times), flush=True)
    print("[profiling] profile_main_path.profile_compat: [compat]'s encode and decode, timed and profiled:", flush=True)
    profile_compat(CIF_FRAMES, 5)

    # ---- the kernels' line: this run's counts, errors, times and bounds
    px = H * W
    out_a = nb * (12 + 4 + 1) + 2 * px
    out_v = nb * 5 * (12 + 4 + 1)

    def mode_row(name, source, replaces, launches, nbytes, ops):
        m = modes[name]
        return _kernel_row(name, source, replaces, launches, m["err"], m["ms"], m["plain_ms"], nbytes, ops,
                           int_ops_per_ms, library_ms=m["lib_ms"])

    def with_mode(row, prefix, nbytes, ops, m):
        """``row`` with another mode's numbers under ``<prefix>_*`` keys."""
        bound_ms, bound_by = _bound(nbytes, ops, int_ops_per_ms)
        row.update({f"{prefix}_max_abs_err": m["err"], f"{prefix}_ms": m["ms"], f"{prefix}_plain_ms": m["plain_ms"],
                    f"{prefix}_bound_ms": bound_ms, f"{prefix}_bound_by": bound_by,
                    f"{prefix}_library_ms": m.get("lib_ms")})
        return row

    kernels = [
        with_mode(_kernel_row("full_search", "full_search.cu", 213, whole["launches"]["full_search"], err_a, ms_a,
                              plain_ms_a, 2 * px + out_a, _search_ops(H, W, 1, False, dev, vbs=False),
                              int_ops_per_ms),
                  "nref4", 5 * px + out_a, _search_ops(H, W, 4, False, dev, vbs=False), modes["full_search nref=4"]),
        with_mode(with_mode(mode_row("full_search_vbs", "full_search.cu", 213,
                                     tools["main-vbs"]["launches"]["full_search_vbs"], 2 * px + out_v,
                                     _search_ops(H, W, 1, False, dev)),
                            "nref4", 5 * px + out_v, _search_ops(H, W, 4, False, dev), modes["full_search_vbs nref=4"]),
                  "sr16", 2 * px + out_v, _search_ops(H, W, 1, False, dev, sr=16), modes["full_search_vbs sr=16"]),
        mode_row("full_search_fme", "full_search_fme.cu", 621, tools["main-fme"]["launches"]["full_search_fme"],
                 px + planes.numel() + nb * 17, _search_ops(H, W, 1, True, dev, vbs=False)),
        _kernel_row("full_search_fme_vbs", "full_search_fme.cu", 621, vf["launches"]["full_search_fme_vbs"], err_c,
                    ms_c, plain_ms_c, px + planes.numel() + out_v, _search_ops(H, W, 1, True, dev), int_ops_per_ms),
        with_mode(_kernel_row("pred_fetch", "pred_fetch.cu", 1020, whole["launches"]["pred_fetch"], err_b, ms_b,
                              plain_ms_b, nb * 12 + _fetch_bytes_read(mv_main, ref) + 2 * px, 0, int_ops_per_ms,
                              library_ms=lib_ms_b),
                  "nref4", nb * 12 + _fetch_bytes_read(win4, ref4) + 2 * px, 0, modes["pred_fetch nref=4"]),
        mode_row("pred_fetch_vbs", "pred_fetch.cu", 1020, tools["main-vbs"]["launches"]["pred_fetch_vbs"],
                 nb * 5 * 12 + _fetch_bytes_read(win_v["mv"], ref, win_v["sub_mv"]) + 4 * px, 0),
        mode_row("pred_fetch_fme", "pred_fetch.cu", 1020, tools["main-fme"]["launches"]["pred_fetch_fme"],
                 nb * 12 + _fetch_bytes_read(win_f["mv"], planes, fme=True) + 2 * px, 0),
        _kernel_row("pred_fetch_fme_vbs", "pred_fetch.cu", 1020, vf["launches"]["pred_fetch_fme_vbs"], err_d, ms_d,
                    plain_ms_d, nb * 5 * 12 + _fetch_bytes_read(win["mv"], planes, win["sub_mv"], fme=True) + 4 * px, 0,
                    int_ops_per_ms),
    ]
    # the compat engine's quad margin (K18) on the same MVs: launches counted by the wrapper in [compat] (the
    # reconstruction's and the decode's fetches), bytes as that margin reads them
    with_mode(kernels[-1], "k18", nb * 5 * 12 + _fetch_bytes_read(win["mv"], planes, win["sub_mv"], fme=True,
                                                                  quad_margin=BS_) + 4 * px, 0,
              {"err": k18["err"], "ms": k18["ms"], "plain_ms": k18["plain_ms"]})
    kernels[-1]["k18_launches"] = compat["compat"]["margin_launches"]
    dct_row["launches"] = compat["compat"]["launches"]["dct_scipy"]
    kernels.append(dct_row)
    # the intra reconstruction and the residual coding: their launches on [main-fast-vbs-fme], whose frames
    # the rows time
    intra_row["launches"] = fast["main-fast-vbs-fme"]["launches"]["intra_recon"]
    kernels.append(intra_row)
    for name, row in residual_rows.items():
        row["launches"] = fast["main-fast-vbs-fme"]["launches"][name]
        kernels.append(row)
    kernels.append(rle_row)  # its launches: the [binary] phase's container writes
    kernels.append(unpack_row)  # its launches: the [binary] phase's decodes
    # the two fast-ME kernels: the FME mode's numbers, the whole-pel mode's under whole_pel_* keys
    rows = {}
    for fme, label in ((True, "main-fast-vbs-fme"), (False, "main-fast")):
        ch, launches = chain[fme], fast[label]["launches"]
        flat = ch["flat"]
        rows[fme] = (
            _kernel_row("rowscan_pass", "rowscan_pass.cu", 1443, launches["rowscan_pass"], ch["err"], ch["ms"],
                        ch["plain_ms"], px + flat.numel() + 2 * S * 12 + nb * 12,
                        _chain_ops(ch["g"], 1, fme, dev), int_ops_per_ms),
            _kernel_row("window_fetch", "window_fetch.cu", 1267, launches["window_fetch"], ch["werr"], ch["wms"],
                        ch["wplain_ms"], _window_bytes_read(flat, ch["by0"], ch["bx0"], BS_ + 2) + nb * 8
                        + nb * flat.shape[0] * (BS_ + 2) ** 2, 0, int_ops_per_ms, library_ms=ch["wlib_ms"]))
        rows[fme][1]["write_floor_ms"] = ch["wfloor_ms"]
    confirm_rows = {}
    for fme, label in ((True, "main-fast-vbs-fme"), (False, "main-fast")):
        confirm_rows[fme] = dict(chain[fme]["confirm"], launches=fast[label]["launches"]["fast_confirm"])
    rows = {fme: (*rows[fme], confirm_rows[fme]) for fme in rows}
    for row, wp in zip(rows[True], rows[False]):
        row.update({f"whole_pel_{k}": wp[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                      "bound_by", "library_ms")})
        if "write_floor_ms" in wp:
            row["whole_pel_write_floor_ms"] = wp["write_floor_ms"]
        kernels.append(row)
    # window_fetch at four references under FME (the nref4_* keys) and on unaligned planes (unaligned_*)
    w4, wu = chain[True]["nref4"], chain[True]["unaligned"]
    bound_ms, bound_by = _bound(w4["bytes"], 0, int_ops_per_ms)
    u_bound_ms, u_bound_by = _bound(wu["bytes"], 0, int_ops_per_ms)
    rows[True][1].update({"nref4_max_abs_err": w4["err"], "nref4_ms": w4["ms"], "nref4_plain_ms": w4["plain_ms"],
                          "nref4_bound_ms": bound_ms, "nref4_bound_by": bound_by, "nref4_library_ms": w4["lib_ms"],
                          "nref4_write_floor_ms": w4["floor_ms"],
                          "unaligned_max_abs_err": wu["err"], "unaligned_ms": wu["ms"],
                          "unaligned_plain_ms": wu["plain_ms"], "unaligned_bound_ms": u_bound_ms,
                          "unaligned_bound_by": u_bound_by, "unaligned_library_ms": wu["lib_ms"]})
    # fast ME on a tile, per launch (the mean over the three tiles); frame_ms: a mesh pass's three launches
    tile_rows = {}
    for fme, label in ((True, "mesh-fast-vbs-fme"), (False, "mesh-fast")):
        tl, launches = tiles[fme], mesh_runs[label]["launches"]
        r = _kernel_row("rowscan_pass tile", "rowscan_pass.cu", 1443, launches["rowscan_pass"], tl["err"], tl["ms"],
                        tl["plain_ms"], tl["bytes"], tl["ops"], int_ops_per_ms)
        r["frame_ms"] = tl["pass_ms"]
        w_ = _kernel_row("window_fetch tile", "window_fetch.cu", 1267, launches["window_fetch"], tl["werr"], tl["wms"],
                         tl["wplain_ms"], tl["wbytes"], 0, int_ops_per_ms, library_ms=tl["wlib_ms"])
        w_["write_floor_ms"] = tl["wfloor_ms"]
        tile_rows[fme] = (r, w_)
    for row, wp in zip(tile_rows[True], tile_rows[False]):
        row.update({f"whole_pel_{k}": wp[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                      "bound_by", "library_ms")})
        for k in ("frame_ms", "write_floor_ms"):
            if k in wp:
                row[f"whole_pel_{k}"] = wp[k]
        kernels.append(row)
    for name, (source, replaces, _, _) in BAND_MODES.items():  # the band modes, per launch on a tile
        b = band[name]
        launches = sum(r["launches"].get(name, 0) for label, r in mesh_runs.items() if label not in mesh_fast)
        row = _kernel_row(f"{name} band", source, replaces, launches, b["err"], b["ms"], b["plain_ms"], b["bytes"],
                          b["ops"], int_ops_per_ms)
        row["frame_ms"] = b["frame_ms"]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
