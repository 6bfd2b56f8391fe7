"""Timing and tracing instrumentation.

The port's twin of ``streamoptima_tpu.profiling``, itself the twin of the
reference's manual timing harness (per-ParallelMode intra/inter second
lists, Encoder.py:62-69, :494-498, :1265-1267, :1777-1782, printed at
:1897):

- ``time_steps``: per-frame-kind step latencies, synchronised.  Kernels are
  queued asynchronously, so timestamps inside the encode loop would time
  the host; this re-runs ``TorchCodec``'s steps and waits for the card after
  each (``torch.cuda.synchronize``).
- ``trace``: a ``torch.profiler`` context over the host and, where there is
  one, the card, with the codec's own tracer on; exported as a Chrome trace
  for per-kernel breakdowns, beside the tracer's spans.
- ``tracer``: the codec's spans and counters, off by default (below).

``python3 -m streamoptima_tpu_torch.profile_main_path`` is the fuller
breakdown (device busy time, idle share, top device ops, the tracer's
readings and idle time by span) of the 720p paths.

The tracer
----------
``tracer`` is the process's one tracer.  It is off until
``tracer.enable()`` or ``with profiling.trace(log_dir):`` turns it on, and
``tracer.disable()`` turns it off again.  Off, a span site costs one
attribute check and a shared null context: no sync, no record.  On, each
span records its name, start and end (``time.perf_counter_ns``), the id of
the span it opened under, a request id and a few attributes, and is also a
profiler range (a ``record_function``) named ``streamoptima.<span>``: the
profiler holds the codec's spans on its own clock, beside the
device operations they launched, and ``trace``'s ``trace.json`` shows both.
The request id is shared by a ``VideoCodec``'s constructor, encode and
writes, and by everything one decode call runs.

Spans (``engine`` is ``TorchCodec``, ``codec`` the ``VideoCodec`` facade):

- ``engine.init`` (the constructor, the clip's upload included),
  ``engine.encode``, ``engine.decode``;
- ``engine.frame``: one frame of an encode pass or of a decode, with
  attributes ``index``, ``type`` (0 intra, 1 inter) and ``launches``: each
  hand-written kernel's launches in the frame (the change of its wrapper's
  ``.launches`` counter; kernels run only on a card);
- ``engine.intra_step``, ``engine.inter_step``; in them ``engine.fast_chain``
  (attribute ``passes``), ``engine.confirm``, ``engine.search`` (a full
  search's launch and its winners' fetch; attribute ``refs``, the
  references searched), ``engine.fetch`` (the prediction planes), all four
  ``core/motion.py``'s, and ``engine.residual``;
- ``engine.package`` (``build_package``), ``engine.pack_stream`` and
  ``engine.upload_stream`` (every decoder's host pass and its uploads);
- ``codec.fetch`` (the last encode's per-frame arrays, copied to the host
  for the writers), ``codec.finish`` (decoded frames to the host);
- ``binstream.write`` with ``binstream.rle_encode``, ``binstream.read``
  with ``binstream.rle_decode``;
- ``sync.<site>``: one host read of a device value (``to_host``,
  ``host_flag``): the host's wait for the card plus the copy.

Counters, by site: ``host_syncs`` (reads of a device value), ``d2h_bytes``
(bytes copied to the host), ``h2d_bytes`` (bytes uploaded, ``to_device``),
and ``pageable_bytes`` by direction (the part of either that left or
reached pageable host memory).  The read sites are ``chain_flag`` (fast
ME's convergence flag, one a pass), ``promote_size`` (scene-change
promotion's size read), ``package`` (the package's three copies),
``fetch`` (the per-frame arrays), ``two_pass_bits`` and ``finish``; the
upload sites ``clip``, ``stream``, ``row_qps``, ``rle_table`` (the
``rle_pack`` kernel's table of the frames' tensors) and ``container`` (a
binary container's coded lists, from the decoder's pinned stage, for
``rle_unpack``).  The helpers count on
the CPU too.  ``rle_frames``, by site, counts the frames the binary
container's writer codes: ``device``, the frames of a package's tensors
coded by ``rle_pack`` (the kernel on a card, its plain twin on the CPU),
and ``host``, the frames of host arrays coded by ``native`` (or its Python
twin).  ``rle_decoded_frames``, by site, counts the frames of a binary
container whose lists are decoded: ``device``, by ``rle_unpack`` in a
decoder's upload (the kernel on a card, its plain twin on the CPU), and
``host``, by ``native`` (or its Python twin) where a reader's frame is
densified (``binstream.CodedResiduals.qf``).  ``confirm_blocks``, by route, counts the blocks the fast-ME
confirm searched: ``kernel``, by the ``fast_confirm`` kernel on a card, and
``plain``, by its plain twin (``core.fastme.confirm``) on the CPU.
``search_positions``, by search wrapper (``full_search``,
``full_search_vbs``, ``full_search_fme``, ``full_search_fme_vbs``), counts
the candidates a full search of either engine can pick, per block and reference: those of
the (2r + 1)^2 positions (r the search range on the whole-pel grid, twice it
on the half-pel grid) that the search's bounds make valid for the block or,
with VBS, for one of its quads (``core.me.valid_candidates``, from the
shapes: no sync), summed over the blocks and the references searched.

``tracer.snapshot()`` returns {"spans": {name: {"seconds", "count"}},
"host_syncs", "d2h_bytes", "h2d_bytes", "rle_frames": {site: count}, "rle_decoded_frames": {site: count},
"pageable_bytes": {"d2h", "h2d"}, "search_positions": {wrapper: count},
"confirm_blocks": {route: count}};
``tracer.reset()`` empties the spans and the counters;
``tracer.write(path)`` writes the spans with their attributes and the
snapshot as JSON.  The codec's outputs are the same with the tracer on or
off.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import time
from collections import Counter

import numpy as np
import torch


#: a profiler range: the C++ one where this PyTorch has it, a twentieth of ``record_function``'s cost
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) or torch.profiler.record_function


class _NullSpan:
    """A span site's context while the tracer is off: one shared instance."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("tracer", "name", "attrs", "id", "parent", "request", "t0", "_range")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name, self.attrs = tracer, name, {}

    def __enter__(self):
        tr = self.tracer
        above = tr._stack[-1] if tr._stack else None
        self.id = next(tr._ids)
        self.parent = None if above is None else above.id
        if above is not None:
            self.request = above.request
        else:
            self.request = tr._request if tr._request is not None else tr.new_request()
        self._range = _RANGE("streamoptima." + self.name)
        self._range.__enter__()
        tr._stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self.tracer
        tr._stack.pop()
        self._range.__exit__(None, None, None)
        tr.records.append((self.name, self.id, self.parent, self.request, self.t0, t1, self.attrs))
        return False


def _launch_counters() -> list:
    """The hand-written kernels' wrappers, each with its ``.launches`` counter."""
    from streamoptima_tpu_torch.core import kernels as K

    return [(name, fn) for name, fn in vars(K).items()
            if callable(fn) and isinstance(getattr(fn, "launches", None), int)]


class _FrameSpan(_Span):
    """``engine.frame``: a span that also records each kernel's launches inside it."""

    __slots__ = ("_before",)

    def __init__(self, tracer: "Tracer", index: int):
        super().__init__(tracer, "engine.frame")
        self.attrs["index"] = index

    def __enter__(self):
        self._before = [fn.launches for _, fn in self.tracer._kernels()]
        return super().__enter__()

    def __exit__(self, *exc):
        kernels = self.tracer._kernels()
        self.attrs["launches"] = {name: fn.launches - n for (name, fn), n in zip(kernels, self._before)
                                  if fn.launches != n}
        return super().__exit__(*exc)


class _Request:
    """Spans opened inside carry request id ``rid``, unless a request is already open."""

    __slots__ = ("tracer", "rid", "opened")

    def __init__(self, tracer: "Tracer", rid):
        self.tracer, self.rid = tracer, rid

    def __enter__(self):
        tr = self.tracer
        self.opened = tr._request is None
        if self.opened:
            tr._request = tr.new_request() if self.rid is None else self.rid
        return self

    def __exit__(self, *exc):
        if self.opened:
            self.tracer._request = None
        return False


class Tracer:
    """The codec's spans and counters (the module docstring says which)."""

    def __init__(self):
        self.on = False
        self._ids = itertools.count()
        self._requests = itertools.count()
        self._stack: list = []
        self._request = None
        self._kernel_list = None
        self.reset()

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def reset(self) -> None:
        """Empty the recorded spans and the counters."""
        #: finished spans: (name, id, parent id, request id, start ns, end ns, attributes)
        self.records: list = []
        self.host_syncs: Counter = Counter()
        self.d2h_bytes: Counter = Counter()
        self.h2d_bytes: Counter = Counter()
        self.pageable_bytes: Counter = Counter()
        self.rle_frames: Counter = Counter()
        self.rle_decoded_frames: Counter = Counter()
        self.search_positions: Counter = Counter()
        self.confirm_blocks: Counter = Counter()

    def new_request(self) -> int:
        """A fresh request id."""
        return next(self._requests)

    def span(self, name: str):
        """A context for one span named ``name`` (shared and empty while off)."""
        if not self.on:
            return _NULL
        return _Span(self, name)

    def frame(self, index: int):
        """The ``engine.frame`` span of frame ``index``."""
        if not self.on:
            return _NULL
        return _FrameSpan(self, index)

    def set(self, key: str, value) -> None:
        """Set one attribute of the innermost open span."""
        if self.on and self._stack:
            self._stack[-1].attrs[key] = value

    def request(self, rid: int | None = None):
        """Spans opened inside carry request id ``rid`` (a fresh one if None),
        unless they open inside a request or a span already."""
        if not self.on:
            return _NULL
        return _Request(self, rid)

    def _kernels(self) -> list:
        if self._kernel_list is None:
            self._kernel_list = _launch_counters()
        return self._kernel_list

    def snapshot(self) -> dict:
        """Per span name its seconds and count, and the counters by site."""
        spans: dict = {}
        for name, _, _, _, t0, t1, _ in self.records:
            s = spans.setdefault(name, {"seconds": 0.0, "count": 0})
            s["seconds"] += (t1 - t0) / 1e9
            s["count"] += 1
        return {"spans": spans, "host_syncs": dict(self.host_syncs), "d2h_bytes": dict(self.d2h_bytes),
                "h2d_bytes": dict(self.h2d_bytes), "pageable_bytes": dict(self.pageable_bytes),
                "rle_frames": dict(self.rle_frames), "rle_decoded_frames": dict(self.rle_decoded_frames),
                "search_positions": dict(self.search_positions),
                "confirm_blocks": dict(self.confirm_blocks)}

    def write(self, path, first_id: int = 0) -> None:
        """Write the spans from id ``first_id`` on, with their attributes, and
        the snapshot, as JSON."""
        keys = ("name", "id", "parent", "request", "start_ns", "end_ns", "attrs")
        spans = [dict(zip(keys, r)) for r in self.records if r[1] >= first_id]
        with open(path, "w") as f:
            json.dump({"spans": spans, "snapshot": self.snapshot()}, f)


#: the process's tracer
tracer = Tracer()


def traced(name: str):
    """Decorator: each call of the function is a span named ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not tracer.on:
                return fn(*args, **kwargs)
            with _Span(tracer, name):
                return fn(*args, **kwargs)

        return call

    return wrap


def _count(counter: Counter, direction: str, site: str, nbytes: int, pinned: bool) -> None:
    counter[site] += nbytes
    if not pinned:
        tracer.pageable_bytes[direction] += nbytes


def to_host(t: torch.Tensor, site: str) -> np.ndarray:
    """``t.cpu().numpy()``; with the tracer on, the span ``sync.<site>`` and
    one host sync and the copy's bytes counted at ``site``."""
    if not tracer.on:
        return t.cpu().numpy()
    with tracer.span("sync." + site):
        host = t.cpu()
        out = host.numpy()
    tracer.host_syncs[site] += 1
    _count(tracer.d2h_bytes, "d2h", site, out.nbytes, host.is_pinned())
    return out


def host_flag(t: torch.Tensor, site: str) -> bool:
    """``bool(t)`` of a one-element tensor, counted as ``to_host``."""
    if not tracer.on:
        return bool(t)
    with tracer.span("sync." + site):
        flag = bool(t)
    tracer.host_syncs[site] += 1
    _count(tracer.d2h_bytes, "d2h", site, t.element_size() * t.numel(), False)
    return flag


def to_device(a, device, site: str, pinned: bool = False) -> torch.Tensor:
    """``torch.from_numpy(a).to(device)``, or with ``pinned`` (a CUDA
    device) staged in pinned memory and copied without waiting for the
    device's queue (the caching host allocator holds the stage until the
    copy has run); with the tracer on, its bytes counted at ``site``
    (pageable unless ``pinned``).  ``a``: a numpy array, or a host tensor
    (with ``pinned``, one already in pinned memory is copied from where it
    lies: a stage its caller keeps)."""
    if tracer.on:
        _count(tracer.h2d_bytes, "h2d", site, a.nbytes, pinned)
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
    if not pinned:
        return t.to(device)
    return (t if t.is_pinned() else t.pin_memory()).to(device, non_blocking=True)


def time_steps(cfg, y_frames, warmup: int = 1, iters: int = 8, *, device="cuda") -> dict:
    """Measure per-frame step latencies for each frame kind on ``device``.

    Returns {"intra_s": [...], "inter_s": [...], "decode_inter_s": [...],
    "decode_intra_s": [...]}, each a list of ``iters`` seconds (the
    reference's self.intraN/interN, Encoder.py:62-69).  The steps are the
    encode loop's: ``_intra_step``; the references' planes and
    ``_inter_step``; the decode's planes, prediction fetch (``Motion.fetch``) and
    ``_recon_inter``; ``_recon_intra``.  Frame 1 (or 0) is coded against
    frame 0, at the table rows' QPs."""
    from streamoptima_tpu_torch.engine import TorchCodec

    codec = TorchCodec(cfg, y_frames, device=device)
    n = min(len(codec.y), 2)
    cur = codec._y_dev[n - 1]
    refs = [codec._y_dev[0]]
    sync = torch.cuda.synchronize if codec.device.type == "cuda" else (lambda: None)
    out = {}

    def run(name, fn):
        for _ in range(warmup):
            fn()
            sync()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t0)
        out[name] = times

    run("intra_s", lambda: codec._intra_step(cur))
    mo = codec.motion
    run("inter_s", lambda: codec._inter_step(cur, mo.planes(refs)))
    enc = codec._inter_step(cur, mo.planes(refs))
    sub_mv = enc["sub_mv"] if codec.vbs else None

    def decode_inter():
        pred_full, pred_q = mo.fetch(enc["mv"], sub_mv, mo.planes(refs))
        return codec._recon_inter(pred_full, pred_q, enc["split"], enc["qtc_full"], enc["qtc_quads"])

    run("decode_inter_s", decode_inter)
    enc_i = codec._intra_step(cur)
    run("decode_intra_s", lambda: codec._recon_intra(enc_i["mv"], enc_i["split"], enc_i["sub_mv"],
                                                     enc_i["qtc_full"], enc_i["qtc_quads"]))
    return out


def report(times: dict) -> str:
    """Human-readable table (the reference's end-of-encode print, Encoder.py:1897)."""
    lines = []
    for k, v in times.items():
        v = np.asarray(v)
        lines.append(f"{k:>16}: mean {v.mean()*1e3:8.2f} ms   min {v.min()*1e3:8.2f} ms   max {v.max()*1e3:8.2f} ms")
    return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir):
    """``torch.profiler`` over the block, with the tracer on: host activity,
    the codec's spans and the card's operations where a CUDA device is
    visible.  On exit the tracer is as it was before, the trace is written
    to ``log_dir/trace.json`` (Chrome trace format: chrome://tracing or
    Perfetto; the spans are its ``streamoptima.*`` ranges) and the spans the
    block recorded, with their attributes, to ``log_dir/spans.json``
    (``Tracer.write``).  Yields the profiler (``key_averages()`` for sums by
    op)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    was_on, first_id = tracer.on, next(tracer._ids)
    tracer.enable()
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        tracer.on = was_on
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))
    tracer.write(os.path.join(str(log_dir), "spans.json"), first_id)
