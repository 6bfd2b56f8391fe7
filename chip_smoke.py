"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``streamoptima_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card at the 720p shapes, then
drives the port's main path through the ``VideoCodec`` facade at the config
``bench.py`` runs (720p IPPP, bs=16, sr=8, qp=4, intra_dur=8, one reference,
whole-pel full search): encode 16 frames (2 GOPs) -> text bitstream ->
decode, bit-exact, with every inter frame going through the kernels.

Every comparison is exact (tolerance 0): the codec's arithmetic is integer.
Prints one line per phase, then the kernels' JSON line, the card's name and
power limit, and as the last line ``{"ok": true, "device": {...}}``.  Any
failed phase raises, so the exit code is non-zero and no result is printed;
without a CUDA card it fails at once.
"""
from __future__ import annotations

import json
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from streamoptima_tpu_torch import CodecConfig, _build, synthetic_clip
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.core import transform as T
from streamoptima_tpu_torch.engine import TorchCodec

H, W, FRAMES = 720, 1280, 16
BS_, SR, QP, INTRA_DUR = 16, 8, 4, 8
N_INTER = FRAMES - FRAMES // INTRA_DUR
MIN_PSNR = 30.0  # qp=4 on the smooth synthetic clip sits near 35 dB


def _cfg(h=H, w=W, frames=FRAMES) -> CodecConfig:
    return CodecConfig(height=h, width=w, frames=frames, block_size=BS_, search_range=SR, qp=QP,
                       intra_dur=INTRA_DUR, lam=0.015)


def _time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events, warm)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_err(a: dict, b: dict, keys) -> int:
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) for x, y in
               ((a[k], b[k]) for k in keys))


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> None:
    # ---- phase 1: device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] {smi} | torch {torch.__version__} | cuda {torch.version.cuda}", flush=True)

    # ---- phase 2: build
    b = _build.build()
    _build.library()
    print(f"[build] {b.seconds:.1f} s ({'cached' if b.cached else 'nvcc'}) {b.path.name}", flush=True)
    for line in b.log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    # ---- phase 3: each kernel against its plain version, on the card, at 720p
    clip = synthetic_clip(H, W, FRAMES)
    cur = torch.from_numpy(clip[1]).to(dev)
    ref = torch.from_numpy(clip[0]).to(dev)[None].contiguous()
    pairs = {
        "clip": (cur, ref),
        "black_vs_white": (torch.zeros_like(cur), torch.full_like(ref, 255)),
        "flat_ties": (torch.full_like(cur, 77), torch.full_like(ref, 77)),
    }
    err_a = 0
    for name, (c, r) in pairs.items():
        got, plain = K.full_search(c, r, SR, BS_), K.full_search_plain(c, r, SR, BS_)
        torch.cuda.synchronize()
        for k in ("mv", "sad", "ok", "pred"):
            _require(torch.equal(got[k], plain[k]), f"full_search {name}: {k} differs from the plain version")
        err_a = max(err_a, _max_err(got, plain, ("mv", "sad", "pred")))
    ms_a = _time_ms(lambda: K.full_search(cur, ref, SR, BS_), 50)
    plain_ms_a = _time_ms(lambda: K.full_search_plain(cur, ref, SR, BS_), 5)
    print(f"[kernel] full_search 720p sr={SR}: bit-equal (tolerance 0) on {list(pairs)}; {ms_a:.4f} ms vs "
          f"plain {plain_ms_a:.4f} ms", flush=True)

    rng = np.random.default_rng(0)
    nb = (H // BS_) * (W // BS_)
    mv_adv = np.stack([rng.integers(-3 * SR, 3 * SR + 1, nb), rng.integers(-3 * SR, 3 * SR + 1, nb),
                       np.zeros(nb, int)], 1).astype(np.int32)
    mv_adv[:: W // BS_, 0] = -SR  # left column: windows leave the frame
    mv_adv[-(W // BS_):, 1] = SR  # bottom row too
    mv_adv[7] = (5000, -5000, 0)  # entirely outside
    mv_main = K.full_search(cur, ref, SR, BS_)["mv"]
    err_b = 0
    for name, mv in (("adversarial", torch.from_numpy(mv_adv).to(dev)), ("search_winners", mv_main)):
        got, plain = K.pred_fetch(mv, ref, BS_), K.pred_fetch_plain(mv, ref, BS_)
        torch.cuda.synchronize()
        _require(torch.equal(got, plain), f"pred_fetch {name}: differs from the plain version")
        err_b = max(err_b, _max_err({"p": got}, {"p": plain}, ("p",)))
    ms_b = _time_ms(lambda: K.pred_fetch(mv_main, ref, BS_), 200)
    plain_ms_b = _time_ms(lambda: K.pred_fetch_plain(mv_main, ref, BS_), 20)
    print(f"[kernel] pred_fetch 720p: bit-equal (tolerance 0) on adversarial and search-winner MVs; "
          f"{ms_b:.4f} ms vs plain {plain_ms_b:.4f} ms", flush=True)

    x = rng.integers(-255, 256, (nb, 16, 16)).astype(np.int32)
    x[0], x[1] = 255, -255
    t = rng.integers(-12288, 12289, (nb, 16, 16)).astype(np.int32)
    t[0], t[1] = 12288, -12288
    for f, a in ((T.dct2_int, x), (T.idct2_int, t)):
        _require(torch.equal(f(torch.from_numpy(a).to(dev)).cpu(), f(torch.from_numpy(a))),
                 f"{f.__name__} on the card differs from the CPU port")
    print(f"[transform] dct2_int / idct2_int on the card bit-equal to the CPU port ({nb} blocks, extremes)",
          flush=True)

    small = synthetic_clip(64, 96, 6, seed=3)
    a = TorchCodec(_cfg(64, 96, 6), small, device=dev).encode(package=False)
    b_ = TorchCodec(_cfg(64, 96, 6), small, device="cpu").encode(package=False)
    _require(np.array_equal(a["reconstructed frames"], b_["reconstructed frames"]),
             "small encode on the card differs from the CPU port")
    print("[reference] 64x96 6-frame encode on the card equals the CPU port (held to the JAX engine by "
          "the CPU tests)", flush=True)

    # ---- phase 4: the main path
    warm = VideoCodec(_cfg(frames=3), clip[:3], device=dev)  # one-time library / allocator set-up
    warm.encode(compute_ssim=False, package=False)
    K.full_search.launches = 0
    K.pred_fetch.launches = 0
    enc = VideoCodec(_cfg(), clip, device=dev)
    torch.cuda.synchronize()
    pkg = enc.encode(package=False)  # ends in a device-to-host copy of the stats: synchronised
    enc_s = pkg["timing"]["total_s"]
    with tempfile.TemporaryDirectory() as d:
        mv_f, res_f = Path(d) / "mv.txt", Path(d) / "res.txt"
        t0 = time.perf_counter()
        enc.transmit_bitstream(mv_f, res_f)
        tx_s = time.perf_counter() - t0
        dec = VideoCodec(_cfg(), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = dec.decode_bitstream(mv_f, res_f)  # ends in a device-to-host copy
        dec_s = time.perf_counter() - t0
        launches = {"full_search": K.full_search.launches, "pred_fetch": K.pred_fetch.launches}
        t0 = time.perf_counter()
        parsed = dec.parse_bitstream(mv_f, res_f)
        parse_s = time.perf_counter() - t0
        mv_bytes, res_bytes = mv_f.stat().st_size, res_f.stat().st_size
    recon = pkg["reconstructed frames"]
    _require(frames.shape == recon.shape == (FRAMES, H, W) and frames.dtype == np.uint8, "decoded shape/dtype")
    _require(np.array_equal(frames, recon), "decoded frames differ from the encoder's reconstructions")
    _require(launches == {"full_search": N_INTER, "pred_fetch": N_INTER},
             f"kernel launches in the main path {launches}, expected {N_INTER} each")
    psnr = np.asarray(pkg["PSNR per frame"])
    _require(np.isfinite(psnr).all() and psnr.mean() > MIN_PSNR, f"PSNR {psnr}")
    _require(pkg["frame_type_seq"] == [0 if i % INTRA_DUR == 0 else 1 for i in range(FRAMES)], "frame types")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames2 = dec.decode(*parsed)  # in-memory decode of the parsed stream; ends in a device-to-host copy
    dec_mem_s = time.perf_counter() - t0
    _require(np.array_equal(frames2, recon), "in-memory decode differs")
    print(f"[main] 720p {FRAMES} frames ({N_INTER} inter): encode {FRAMES / enc_s:.2f} fps ({enc_s:.4f} s), "
          f"text bitstream write {tx_s:.3f} s ({mv_bytes + res_bytes} bytes), decode_bitstream "
          f"{FRAMES / dec_s:.2f} fps ({dec_s:.4f} s incl. parse; parse alone {parse_s:.3f} s), in-memory "
          f"decode {FRAMES / dec_mem_s:.2f} fps ({dec_mem_s:.4f} s); decode == recon bit-exact; "
          f"launches {launches}", flush=True)
    print(f"[main] mean PSNR {psnr.mean():.4f} dB, mean SSIM {np.mean(pkg['SSIM per frame']):.5f}, "
          f"bits {sum(pkg['residual size per frame'])}", flush=True)

    kernels = [
        {"name": "full_search", "route": "cuda", "source": "streamoptima_tpu_torch/csrc/full_search.cu",
         "replaces": "streamoptima_tpu/core/me_pallas.py:213", "launches": launches["full_search"],
         "max_abs_err": err_a, "ms": ms_a, "plain_ms": plain_ms_a},
        {"name": "pred_fetch", "route": "cuda", "source": "streamoptima_tpu_torch/csrc/pred_fetch.cu",
         "replaces": "streamoptima_tpu/core/me_pallas.py:1020", "launches": launches["pred_fetch"],
         "max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_ms_b},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
