"""Where the 720p main path's time goes on one CUDA card.

    python3 -m streamoptima_tpu_torch.profile_main_path [--frames 16] [--reps 20] [--vbs] [--fme] [--nref N]
                                                         [--fast] [--mesh SHARDS] [--rc] [--two-pass]
    python3 -m streamoptima_tpu_torch.profile_main_path --compat [--frames 21] [--reps 5]

Runs the ``chip_smoke.py`` configuration (720p IPPP, bs=16, sr=8, qp=4,
intra_dur=8, one reference, whole-pel full search) with the tools the flags
add: ``--vbs`` variable block size, ``--fme`` half-pel FME, ``--nref N`` N
reference frames, ``--fast`` fast ME at sr=16.  So ``--vbs`` is
``[main-vbs]``, ``--nref 4`` ``[main-nref4]``, ``--vbs --fme``
``[main-vbs-fme]`` and ``--fast --vbs --fme`` ``[main-fast-vbs-fme]``.  On
``synthetic_clip`` (seed 42) it prints, for one intra step, one inter step,
a whole encode and a device decode of the same clip:

- the host-clock median and quartiles of synchronised runs, without the
  profiler;
- from one ``torch.profiler`` run each, with the codec's tracer on
  (``profiling.tracer``): the device busy time (the union of device-side
  events: kernels and copies), the number of device ops, the idle share
  (1 - busy / the profiled run's own wall on the profiler's clock), the
  idle time by the tracer's span that was open (each gap between device
  ops named by the innermost span covering most of it), the tracer's host
  syncs and copied bytes, the ten largest device ops and every hand-written
  kernel (``csrc/``) outside them.

Under ``--fast`` the inter step is timed warm-started from its own converged
MVPs, as every inter frame after a clip's first runs, and the passes per
inter frame of the encode are printed.  The inter step codes frame N
(N = ``--nref``, below ``intra_dur``) from the reconstructions of frames 0
to N - 1: the reference FIFO the encode holds there, full.

``--mesh SHARDS`` times and profiles the encode and the decode on a mesh of
that many shards of the card (``make_mesh(cfg, devices=[cuda] * SHARDS)``;
6 is ``chip_smoke.py``'s data 2 x tile 3) in place of the four single-device
runs: ``--mesh 6`` is ``[mesh]``, ``--mesh 6 --vbs --fme`` ``[mesh-vbs-fme]``,
``--mesh 6 --fast --vbs --fme`` ``[mesh-fast-vbs-fme]`` (it also prints the
mesh's passes per inter frame).

``--compat`` times and profiles the reference-exact engine instead
(``compat_engine.CompatCodec``, ``chip_smoke.py``'s ``[compat]``): the
command line's defaults with ``--engine compat`` (CIF, fast ME + VBS + FME,
sr 16, qp 5) on its synthetic clip, the encode and the device decode of its
package (``profile_compat``).

``--rc`` adds per-row rate control at ``benchmarks/sweep.py``'s settings
(``720p_rc_row_qp``: its tables, 8 mbps, 30 fps), ``--two-pass`` two-pass
rate control on top (``720p_two_pass``); the decode reads the encode's row
QPs.  With ``--mesh 6``, ``--rc`` is ``[mesh-rc]`` and ``--two-pass
--frames 8`` ``[mesh-two-pass]``.

Writes nothing but standard output.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from streamoptima_tpu_torch import CodecConfig, synthetic_clip
from streamoptima_tpu_torch.profiling import tracer
from streamoptima_tpu_torch.compat_engine import CompatCodec
from streamoptima_tpu_torch.engine import TorchCodec, frame_arrays_of


def _wall_ms(fn, reps: int) -> tuple[float, float, float]:
    """Median and quartiles, in ms, of ``reps`` synchronised calls (one warm-up)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), float(np.percentile(ts, 25)), float(np.percentile(ts, 75))


#: the names of the kernels in csrc/, as the profiler lists them
_OWN_KERNELS = ("full_search_kernel", "full_search_fme_kernel", "pred_fetch_kernel", "window_fetch_kernel",
                "rowscan_pass_kernel", "dct_scipy_kernel", "intra_recon_kernel", "transform_select_kernel",
                "residual_recon_kernel", "intra_search_kernel")


def _device_ms(e) -> float:
    return (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)) / 1e3


#: the profiled call's own range, on the profiler's clock
_REGION = "profile_main_path.region"
_SPAN = "streamoptima."


def _annotation(name: str) -> bool:
    return name == _REGION or name.startswith(_SPAN)


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _idle_by_span(gaps: list, spans: list) -> dict:
    """Seconds of the idle ``gaps`` [(start, end)], in time order and
    disjoint, by the innermost of the
    ``spans`` [(name, start, end)] covering at least half of each, else the
    span covering most of it ("outside spans" where none overlaps)."""
    spans = sorted(spans, key=lambda sp: sp[1])
    out: dict = {}
    active, j = [], 0
    for a, b in gaps:
        while j < len(spans) and spans[j][1] < b:
            active.append(spans[j])
            j += 1
        active = [sp for sp in active if sp[2] > a]
        covers = [(min(b, e) - max(a, s), e - s, name) for name, s, e in active if min(b, e) > max(a, s)]
        half = [c for c in covers if 2 * c[0] >= b - a]
        label = min(half, key=lambda c: c[1])[2] if half else max(covers)[2] if covers else "outside spans"
        out[label] = out.get(label, 0.0) + (b - a) / 1e6
    return out


def _profile(name: str, fn) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    tracer.reset()
    tracer.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            with record_function(_REGION):
                fn()
                torch.cuda.synchronize()
    finally:
        tracer.disable()
    # the profiler also lays each range on the card's timeline (user annotations): those are not device work
    ops = [e for e in p.key_averages() if e.device_type == DeviceType.CUDA and _device_ms(e) > 0
           and not _annotation(e.key)]
    region, spans, device = None, [], []
    for ev in p.events():
        tr = ev.time_range
        if ev.device_type == DeviceType.CPU and ev.name == _REGION:
            region = (tr.start, tr.end)
        elif ev.device_type == DeviceType.CPU and ev.name.startswith(_SPAN):
            spans.append((ev.name[len(_SPAN):], tr.start, tr.end))
        elif ev.device_type == DeviceType.CUDA and not _annotation(ev.name):
            device.append((tr.start, tr.end))
    r0, r1 = region
    busy_iv = _union([(max(s, r0), min(e, r1)) for s, e in device if e > r0 and s < r1])
    edges = [r0] + [x for iv in busy_iv for x in iv] + [r1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    idle = sorted(_idle_by_span(gaps, spans).items(), key=lambda kv: -kv[1])
    wall_ms, busy = (r1 - r0) / 1e3, sum(e - s for s, e in busy_iv) / 1e3
    print(f"== {name}: device busy {busy:.4f} ms, device ops {sum(e.count for e in ops)}, "
          f"idle share {1 - busy / wall_ms:.3f} of the profiled run's wall ({wall_ms:.4f} ms)")
    print("   idle by span: " + ", ".join(f"{label} {1e3 * sec:.3f} ms" for label, sec in idle[:8]))
    snap = tracer.snapshot()
    frames = snap["spans"].get("engine.frame", {}).get("count", 0)
    if frames:
        print(f"   tracer, per frame over {frames}: host syncs {sum(snap['host_syncs'].values()) / frames:.3f} "
              f"{snap['host_syncs']}, copied out {sum(snap['d2h_bytes'].values()) / frames / 1e6:.4f} MB, "
              f"in {sum(snap['h2d_bytes'].values()) / frames / 1e6:.4f} MB")
    top = sorted(ops, key=_device_ms, reverse=True)
    # the ten largest, and every hand-written kernel (csrc/) among the rest
    for e in top[:10] + [e for e in top[10:] if any(k in e.key for k in _OWN_KERNELS)]:
        print(f"   {_device_ms(e):9.4f} ms  x{e.count:5d}  {e.key[:110]}")


def _run_steps(steps) -> None:
    """Time each (name, fn, reps) step without the profiler, then profile it."""
    for name, fn, reps in steps:
        med, q1, q3 = _wall_ms(fn, reps)
        print(f"{name}: median {med:.4f} ms, quartiles {q1:.4f} / {q3:.4f} ms over {reps} runs (no profiler)")
    for name, fn, _ in steps:
        _profile(name, fn)


def profile_compat(frames: int = 21, reps: int = 5) -> None:
    """The compat engine at the command line's defaults with ``--engine
    compat`` (CIF, fast ME + VBS + FME, sr 16, qp 5, one GOP of 21 frames),
    ``frames`` frames of its synthetic clip: the encode (without SSIM) and
    the device decode of its package."""
    cfg = CodecConfig(height=288, width=352, frames=frames, block_size=16, search_range=16, qp=5, intra_dur=21,
                      lam=0.015, vbs_enable=True, fme_enable=True, fast_me=True, intra_thresh=70000,
                      engine="compat")
    print(f"[config] compat engine, CIF, {frames} frames, sr=16, fast ME + VBS + half-pel FME, qp 5")
    codec = CompatCodec(cfg, synthetic_clip(288, 352, frames), device=torch.device("cuda"))
    pkg = codec.encode()
    lists = (pkg["frame_type_seq"], pkg["approx residual"], pkg["Qp_per_row_per_frame"], pkg["MVS per Frame"])
    print(f"[fast ME] rowscan_pass passes per inter frame of the encode: {pkg['fast_me_passes']}")
    _run_steps(((f"compat encode, {frames} frames", lambda: codec.encode(), reps),
                (f"compat device decode, {frames} frames", lambda: codec.decode(*lists), reps)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--reps", type=int, default=20, help="timed runs per step; whole runs take half")
    ap.add_argument("--vbs", action="store_true", help="variable block size")
    ap.add_argument("--fme", action="store_true", help="half-pel FME")
    ap.add_argument("--nref", type=int, default=1, help="reference frames (1 to 8)")
    ap.add_argument("--fast", action="store_true", help="fast ME at sr=16 instead of the full search at sr=8")
    ap.add_argument("--mesh", type=int, default=0, help="encode and decode on a mesh of this many shards of the card")
    ap.add_argument("--rc", action="store_true", help="per-row rate control at benchmarks/sweep.py's settings")
    ap.add_argument("--two-pass", action="store_true", help="two-pass rate control (implies --rc)")
    ap.add_argument("--compat", action="store_true",
                    help="the compat engine at the command line's defaults (CIF) instead; --frames defaults to 21")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path: no CUDA card (torch.cuda.is_available() is False)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] {smi} | torch {torch.__version__} | cuda {torch.version.cuda}")
    if args.compat:
        profile_compat(args.frames if args.frames != ap.get_default("frames") else 21, args.reps)
        return

    n = args.frames
    rc = {}
    if args.rc or args.two_pass:
        rc = {"rc_flag": 1, "target_br": "8 mbps", "frame_rate": 30, "two_pass": args.two_pass,
              "qp_rate_tables": [[2e5, 1.2e5, 8e4, 5e4, 3e4, 2e4, 1.2e4, 8e3, 5e3, 3e3, 2e3, 1.2e3]] * 2}
    cfg = CodecConfig(height=720, width=1280, frames=n, block_size=16, search_range=16 if args.fast else 8, qp=4,
                      intra_dur=8, lam=0.015, vbs_enable=args.vbs, fme_enable=args.fme, fast_me=args.fast,
                      n_ref_frames=args.nref, **rc)
    tools = " + ".join(t for t, on in (("VBS", args.vbs), ("half-pel FME", args.fme), ("rate control", bool(rc)),
                                       ("two-pass", args.two_pass)) if on) or "whole-pel"
    print(f"[config] 720p, {n} frames, sr={cfg.search_range}, {tools}, {'fast ME' if args.fast else 'full search'}, "
          f"{args.nref} reference frame(s)")
    clip = synthetic_clip(720, 1280, n)
    codec = TorchCodec(cfg, clip, device=torch.device("cuda"))
    pkg = codec.encode(package=False)
    fts, qps = pkg["frame_type_seq"], pkg["Qp_per_row_per_frame"]
    if rc:
        print(f"[rc] row QPs of the encode's frames 0 and 1: {qps[:2]}")
    pairs = [frame_arrays_of(o, ft) for o, ft in zip(pkg["per_frame"], fts)]
    mvs, res = [m for m, _ in pairs], [r for _, r in pairs]
    y0, y1 = codec._y_dev[0], codec._y_dev[args.nref]
    refs = [o["recon"] for o in pkg["per_frame"][:args.nref]]  # the full FIFO at frame nref
    g0 = None
    if args.fast:
        print(f"[fast ME] rowscan_pass passes per inter frame of the encode: {pkg['fast_me_passes']}")
        g0 = codec._inter_step(y1, codec.motion.planes(refs))["g_next"]

    steps = (("intra step (1 frame)", lambda: codec._intra_step(y0), args.reps),
             (f"inter step (1 frame, {args.nref} reference(s))",
              lambda: codec._inter_step(y1, codec.motion.planes(refs), g0), args.reps),
             (f"encode, {n} frames", lambda: codec.encode(package=False), max(args.reps // 2, 1)),
             (f"device decode, {n} frames", lambda: codec.decode(fts, res, qps, mvs), max(args.reps // 2, 1)))
    if args.mesh:
        from streamoptima_tpu_torch.parallel import ShardedCodec, make_mesh

        mesh = make_mesh(cfg, devices=[torch.device("cuda")] * args.mesh)
        sc = ShardedCodec(cfg, mesh, clip)
        print(f"[mesh] {args.mesh} shards of the card: data {mesh.devices.shape[0]} x tile {mesh.devices.shape[1]}")
        if args.fast:
            print(f"[mesh] rowscan_pass passes per inter frame of the mesh encode (each one launch per tile): "
                  f"{sc.encode(package=False)['fast_me_passes']}")
        steps = ((f"mesh encode, {n} frames", lambda: sc.encode(package=False), max(args.reps // 2, 1)),
                 (f"mesh device decode, {n} frames", lambda: sc.decode(fts, res, qps, mvs), max(args.reps // 2, 1)))
    _run_steps(steps)


if __name__ == "__main__":
    main()
