"""Command line: YUV in -> encode -> bitstream -> decode -> YUV out.

The port's twin of ``streamoptima_tpu.main`` (``python -m
streamoptima_tpu``): the same flags and defaults, mirroring the reference's
main.py:19-43 (CIF, block 16, search range 16, GOP 21, FME + fast ME + VBS,
lam 0.015, intra_thresh 70000), plus ``--device``.  It runs on the CUDA
card by default; without one it exits with a message, and it runs on the
CPU only when asked (``--device cpu``).

    python -m streamoptima_tpu_torch --input video/cif.yuv --frames 21
    python -m streamoptima_tpu_torch --input clip.yuv --height 720 --width 1280 \\
        --frames 32 --no-fast-me --no-fme --no-vbs --mesh
    python -m streamoptima_tpu_torch --synthetic --device cpu --height 64 --width 64 --frames 4

Use --synthetic to run without an input file (deterministic test clip).
``--mesh`` shards over every visible card (``parallel.make_mesh``), so it
refuses an indexed ``--device cuda:N``; with ``--device cpu`` it shards over
an 8-device CPU mesh.  ``--engine compat`` runs the engine that is
bit-exact with the NumPy reference (``compat_engine.CompatCodec``, up to
CIF); it has no binary container and no mesh, so it refuses ``--binary``
and ``--mesh``.  The exit code is 0 only if the text stream's decode (and
with ``--binary`` the container's) equals the encoder's reconstructions.

    python -m streamoptima_tpu_torch --synthetic --engine compat
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.config import CodecConfig
from streamoptima_tpu_torch.io.video import VideoManager


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="streamoptima_tpu_torch", description=__doc__.splitlines()[0])
    p.add_argument("--input", help="raw YUV 4:2:0 file (reference main.py:46)")
    p.add_argument("--synthetic", action="store_true", help="use a deterministic synthetic clip instead of --input")
    p.add_argument("--height", type=int, default=288)
    p.add_argument("--width", type=int, default=352)
    p.add_argument("--frames", type=int, default=21)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--search-range", type=int, default=16)
    p.add_argument("--qp", type=int, default=5)
    p.add_argument("--intra-dur", type=int, default=21)
    p.add_argument("--intra-mode", type=int, default=0, choices=(0, 1))
    p.add_argument("--lam", type=float, default=0.015)
    p.add_argument("--n-ref-frames", type=int, default=1)
    p.add_argument("--no-vbs", dest="vbs", action="store_false")
    p.add_argument("--no-fme", dest="fme", action="store_false")
    p.add_argument("--no-fast-me", dest="fast_me", action="store_false")
    p.add_argument("--rc-flag", type=int, default=None)
    p.add_argument("--target-br", default=None, help='e.g. "2400 kbps" (Encoder.py:78)')
    p.add_argument("--frame-rate", type=int, default=30)
    p.add_argument("--two-pass", action="store_true")
    p.add_argument("--intra-thresh", type=int, default=70000)
    p.add_argument("--engine", default="jax", choices=("jax", "compat"),
                   help="jax: the native engine; compat: bit-exact with the NumPy reference (up to CIF, no "
                        "--binary, no --mesh)")
    p.add_argument("--mesh", action="store_true",
                   help="multi-device encode over every visible card, so --device must be cuda, not cuda:N "
                        "(with --device cpu: 8 CPU devices)")
    p.add_argument("--device", default="cuda", help='"cuda" (default; exits without a card), "cuda:N" or "cpu"')
    p.add_argument("--mv-file", default="files/mvs_per_frame.txt")
    p.add_argument("--residual-file", default="files/res_per_frame.txt")
    p.add_argument("--binary", default=None, metavar="PATH",
                   help="ALSO write + verify the single-file binary container "
                        "(binstream.py; the text files stay the parity format)")
    p.add_argument("--out", default="yuv/y_only_decoded.yuv")
    p.add_argument("--recon-out", default="yuv/y_only_reconstructed.yuv")
    p.add_argument("--vbs-overlay", default=None, help="also write a partition-overlay clip")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t0 = time.time()
    device = torch.device(args.device)
    if args.mesh and device.type == "cuda" and device.index is not None:
        raise SystemExit(f"streamoptima_tpu_torch: --mesh shards over every visible card; it takes --device cuda, "
                         f"not {args.device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"streamoptima_tpu_torch: --device {args.device} but no CUDA card is visible; "
                         "pass --device cpu to run on the CPU")

    cfg = CodecConfig(
        height=args.height, width=args.width, frames=args.frames,
        block_size=args.block_size, search_range=args.search_range, qp=args.qp,
        intra_dur=args.intra_dur, intra_mode=args.intra_mode, lam=args.lam,
        vbs_enable=args.vbs, n_ref_frames=args.n_ref_frames,
        fast_me=args.fast_me, fme_enable=args.fme,
        rc_flag=args.rc_flag, target_br=args.target_br, frame_rate=args.frame_rate,
        qp_rate_tables=None, intra_thresh=args.intra_thresh,
        two_pass=False, engine=args.engine,
    )
    if args.binary and cfg.compat:
        raise SystemExit("--binary requires --engine jax (the compat oracle has no binary format)")
    if args.mesh and cfg.compat:
        raise SystemExit("--mesh requires --engine jax (multi-device encoding is the native engine's)")
    if args.two_pass and not args.rc_flag:
        raise SystemExit("--two-pass requires --rc-flag and --target-br")

    if args.synthetic or not args.input:
        from streamoptima_tpu_torch.utils import synthetic_clip

        y = synthetic_clip(args.height, args.width, args.frames)
        print("[INFO] Using synthetic clip.")
    else:
        vm = VideoManager(args.input, args.height, args.width, args.frames, "yuv_420")
        vm.upscale_yuv420_to_yuv444()
        y = np.ascontiguousarray(vm.extract_y_only())
        print("[INFO] YUV 4:2:0 file read and converted. Now running encoder.")

    if args.rc_flag:
        from streamoptima_tpu_torch import rc

        print("[INFO] Measuring QP rate tables (the reference expects externally measured tables, main.py:43).")
        tables = rc.measure_qp_tables(cfg, y, device=device)
        # two-pass enters the config only with the tables (the JAX command line's order)
        cfg = dataclasses.replace(cfg, qp_rate_tables=tables, two_pass=args.two_pass)

    where = {"device": device}
    if args.mesh:
        from streamoptima_tpu_torch.parallel import make_mesh

        mesh = make_mesh(cfg, devices=["cpu"] * 8 if device.type == "cpu" else None)
        where = {"mesh": mesh}
        print(f"[INFO] Mesh: data={mesh.devices.shape[0]} x tile={mesh.devices.shape[1]} devices.")

    for f in (args.mv_file, args.residual_file, args.out, args.recon_out):
        d = os.path.dirname(f)
        if d:
            os.makedirs(d, exist_ok=True)

    codec = VideoCodec(cfg, y, **where)
    print("[INFO] Encoding")
    pkg = codec.encode()
    print(f"[INFO] Done. mean PSNR {np.mean(pkg['PSNR per frame']):.2f} dB, "
          f"mean SSIM {np.mean(pkg.get('SSIM per frame', [float('nan')])):.4f}, "
          f"residual size {sum(pkg['residual size per frame'])}")
    print("[INFO] Generating Bitstream")
    codec.transmit_bitstream(args.mv_file, args.residual_file)
    codec.save_reconstructed(args.recon_out)
    okb = True
    if args.binary:
        d = os.path.dirname(args.binary)
        if d:
            os.makedirs(d, exist_ok=True)
        codec.transmit_bitstream_binary(args.binary)
        dec_b = VideoCodec(cfg, device=codec.device).decode_bitstream_binary(args.binary)
        okb = np.array_equal(dec_b, pkg["reconstructed frames"])
        print(f"[INFO] Binary container {os.path.getsize(args.binary)} bytes; "
              f"decode {'matches' if okb else 'DOES NOT match'}.")
    print("[INFO] Decoding Bitstream")
    decoded = codec.decode_bitstream(args.mv_file, args.residual_file)
    ok = np.array_equal(decoded, pkg["reconstructed frames"])
    print(f"[INFO] Decode {'matches' if ok else 'DOES NOT match'} encoder reconstruction.")
    print("[INFO] Saving decoded frames")
    codec.save_decoded_frames(args.out, overlay_path=args.vbs_overlay)
    print(f"[INFO] Done in {time.time() - t0:.1f}s")
    return 0 if (ok and okb) else 1


if __name__ == "__main__":
    raise SystemExit(main())
