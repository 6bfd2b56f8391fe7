"""Self-verifying multi-shard dry run of the mesh.

    python3 -m streamoptima_tpu_torch.parallel.dryrun [--device cuda]

The counterpart of ``__graft_entry__.dryrun_multichip``: for each of its six
feature sets, encode a 64x64 clip of 6 frames (intra_dur 3, sr 4) on an
``n_devices``-shard mesh of ``device`` and with ``TorchCodec`` on
``device``, require the two packages to be equal bit for bit, then decode
the mesh's package on the mesh and require the decode to equal the
reconstructions (the encode/decode closed loop, reference Encoder.py:1873).
Prints one line per feature set and a last ``dryrun ok: ...`` line.  Any
difference raises; nothing is caught.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from streamoptima_tpu_torch.config import CodecConfig
from streamoptima_tpu_torch.engine import TorchCodec
from streamoptima_tpu_torch.parallel.mesh import ShardedCodec, make_mesh
from streamoptima_tpu_torch.utils.clips import synthetic_clip

H, W, FRAMES = 64, 64, 6
RC_TABLES = [
    [99000, 60000, 40000, 26000, 17000, 11000, 7200, 4800, 3200, 2100, 1400, 950],
    [60000, 36000, 24000, 16000, 10000, 6600, 4400, 2900, 1900, 1300, 850, 560],
]


def _center_roi() -> np.ndarray:
    roi = np.zeros((H // 16, W // 16), dtype=np.int32)
    roi[1:-1, 1:-1] = -2  # better quality in the frame centre
    return roi


#: the feature sets of ``__graft_entry__.dryrun_multichip``
CASES = {
    # the flagship: full search + VBS + FME
    "vbs_fme": dict(vbs_enable=True, fme_enable=True, lam=0.015),
    # fast ME: the raster MVP chain crosses row tiles.  The JAX case also sets
    # fast_me_fetch="slice" and fast_me_lookahead=2, TPU-only knobs of its
    # window fetch that this package does not have (its one fetch is the
    # window_fetch kernel, and its chain has no lookahead)
    "fast_me_vbs_fme": dict(fast_me=True, vbs_enable=True, fme_enable=True, lam=0.015),
    # scene-change promotion (rc_flag=2) composed with two-pass rate control
    "promotion_two_pass": dict(rc_flag=2, target_br="100 mbps", frame_rate=30, qp_rate_tables=RC_TABLES,
                               intra_thresh=3800, two_pass=True),
    # an ROI map: each tile takes its rows of the per-block QP offsets
    "roi_map": dict(roi_qp_map=_center_roi()),
    # vertical intra (mode 1): the transposed chain, on the "data" axis alone
    "intra_mode1": dict(intra_mode=1, vbs_enable=True),
    # a 4-deep reference FIFO: the halo bands carry 4 references
    "nref4": dict(n_ref_frames=4, vbs_enable=True, fme_enable=True),
}


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def assert_packages_bitwise(single: dict, sharded: dict, tag: str) -> None:
    """Bitwise package equality: frame types, per-frame sizes, row QPs, MV
    lists, coefficient lists, reconstructions (the contract of
    ``tests/test_parallel.py::_compare_packages``), raised with the case's
    name."""
    for key in ("frame_type_seq", "residual size per frame", "Qp_per_row_per_frame"):
        _require(single[key] == sharded[key], f"{tag}: {key} differs")
    np.testing.assert_array_equal(single["reconstructed frames"], sharded["reconstructed frames"],
                                  err_msg=f"{tag}: reconstructions differ")
    for i, (fa, fb) in enumerate(zip(single["MVS per Frame"], sharded["MVS per Frame"])):
        _require(fa == fb, f"{tag}: MVs differ at frame {i}")
    for i, (fa, fb) in enumerate(zip(single["approx residual"], sharded["approx residual"])):
        for (sa, ra), (sb, rb) in zip(fa, fb):
            _require(sa == sb, f"{tag}: split flags differ at frame {i}")
            for x, y in zip([ra] if sa == 0 else list(ra), [rb] if sb == 0 else list(rb)):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                              err_msg=f"{tag}: coefficients differ at frame {i}")


def dryrun_multichip(n_devices: int = 8, device="cuda") -> dict:
    """Run every feature set on an ``n_devices``-shard mesh of ``device``
    against ``TorchCodec`` on ``device``, with the sharded decode's closed
    loop; raises on any difference.  Returns, per feature set, its config,
    the mesh's (data, tile) shape, the frame types and, under fast ME, the
    passes per inter frame of the single-device and of the mesh encode
    (what a caller needs to count the kernel launches the run makes)."""
    device = torch.device(device)
    clip = synthetic_clip(H, W, FRAMES)
    shape = None
    summary = {}
    for tag, extra in CASES.items():
        cfg = CodecConfig(height=H, width=W, frames=FRAMES, block_size=16, search_range=4, qp=4, intra_dur=3,
                          **extra)
        mesh = make_mesh(cfg, devices=[device] * n_devices)
        shape = mesh.devices.shape
        single = TorchCodec(cfg, clip, device=device).encode()
        sc = ShardedCodec(cfg, mesh, clip)
        sharded = sc.encode()
        assert_packages_bitwise(single, sharded, tag)
        dec = torch.stack(sc.decode(sharded["frame_type_seq"], sharded["approx residual"],
                                    sharded["Qp_per_row_per_frame"], sharded["MVS per Frame"])).cpu().numpy()
        np.testing.assert_array_equal(dec, sharded["reconstructed frames"],
                                      err_msg=f"{tag}: the sharded decode does not close the encode loop")
        summary[tag] = {"cfg": cfg, "mesh": shape, "frame_types": sharded["frame_type_seq"],
                        "fast_me_passes": (single.get("fast_me_passes"), sharded.get("fast_me_passes"))}
        print(f"dryrun [{tag}]: mesh=(data={shape[0]}, tile={shape[1]}) of {device}, {FRAMES} frames, frame types "
              f"{sharded['frame_type_seq']}, sharded == single-device bitwise, decode closed loop OK", flush=True)
    print(f"dryrun ok: mesh=(data={shape[0]}, tile={shape[1]}) of {device}, {len(CASES)} feature sets verified "
          "bitwise vs single-device (MVs+coefficients+recon) with sharded-decode closed loop", flush=True)
    return summary


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="the torch device the shards run on (cpu runs without a card)")
    args = ap.parse_args()
    dryrun_multichip(8, args.device)


if __name__ == "__main__":
    main()
