"""The traced run's device slice: a few segments under ``torch.profiler``.

``profile_slice`` runs segments with their spans synchronised and
annotated (``portbench.segment.<k>``, ``portbench.<span>``) inside one
profiler session and reduces the device events to what the per-layer
readers need: the device operations of each segment, by span and by
launch order; the slice's wall time (the segments' own time, as the
profiler's clock has it) and the time in which a device operation ran
(their union); the longest idle gaps, named by the span that was open.
"""
from __future__ import annotations

from collections import defaultdict

from portbench.harness.window import Spans

_SPANS = "portbench."
_SEGMENT = "portbench.segment."


def kernel_name(raw: str) -> tuple[str, str, list]:
    """A device op's printed name -> (name without its arguments, base name,
    template arguments): ``void (anonymous namespace)::k<false, 16>(int*,
    ...)`` -> (``k<false, 16>``, ``k``, ["false", "16"]).  The base name
    drops every namespace."""
    name = raw.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):  # the argument list opens at the first '(' outside template brackets
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    name = name[:cut].strip()
    base, _, rest = name.partition("<")
    base = base.rsplit("::", 1)[-1]
    template = [t.strip() for t in rest[:-1].split(",")] if rest.endswith(">") else []
    return name, base, template


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(ranges: list, device_ops: list, segments: list) -> dict:
    """Reduce one slice.  ``ranges``: the annotated host ranges (name, start
    us, end us); ``device_ops``: (name, start us, end us) of every device
    operation (kernels, copies, memsets); ``segments``: per segment {"slot",
    "frames", "frame_info"}, in order.  Only device work inside a segment's
    range counts."""
    seg_ranges = sorted((int(n[len(_SEGMENT):]), s, e) for n, s, e in ranges if n.startswith(_SEGMENT))
    span_ranges = sorted((n[len(_SPANS):], s, e) for n, s, e in ranges
                         if n.startswith(_SPANS) and not n.startswith(_SEGMENT))
    ops, window_us, busy_us = [], 0.0, 0.0
    gaps = []
    nth = defaultdict(int)

    def span_at(t: float) -> str:
        for name, s, e in span_ranges:
            if s <= t < e:
                return name
        return "outside spans"

    def span_over(a: float, b: float) -> str:
        """The span that covers most of [a, b)."""
        best, label = 0.0, "outside spans"
        for name, s, e in span_ranges:
            cover = min(b, e) - max(a, s)
            if cover > best:
                best, label = cover, name
        return label

    for k, s0, e0 in seg_ranges:
        inside = sorted((s, e, n) for n, s, e in device_ops if s0 <= s < e0)
        window_us += e0 - s0
        busy = _union([(s, min(e, e0)) for s, e, _ in inside])
        busy_us += sum(e - s for s, e in busy)
        edges = [s0] + [x for iv in busy for x in iv] + [e0]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((span_over(a, b), (b - a) / 1e6))
        for s, e, raw in inside:
            name, base, template = kernel_name(raw)
            span = span_at(s)
            key = (k, span, base)
            ops.append({"name": name, "base": base, "template": template, "seg": k, "span": span,
                        "nth": nth[key], "dur_s": (e - s) / 1e6})
            nth[key] += 1
    by_name = defaultdict(float)
    for op in ops:
        by_name[op["name"][:120]] += op["dur_s"]
    idle_by_span = defaultdict(float)
    for label, sec in gaps:
        idle_by_span[label] += sec
    idle = [[f"idle in {label}", sec] for label, sec in sorted(idle_by_span.items(), key=lambda kv: -kv[1])]
    idle += [[f"one gap in {label}", sec] for label, sec in sorted(gaps, key=lambda g: -g[1])][: 10 - len(idle)]
    return {"window_s": window_us / 1e6, "busy_s": busy_us / 1e6, "ops": ops,
            "frames": sum(seg["frames"] for seg in segments), "segments": segments,
            "breakdown": {"device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
                          "idle_gaps": idle[:10]}}


def profile_slice(driver, order, n_segments: int) -> dict:
    """Profile ``n_segments`` segments from the slot iterator ``order``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    spans = Spans(sync=True, annotate=True)
    segments = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(n_segments):
            slot = next(order)
            with record_function(f"{_SEGMENT}{k}"):
                rec = driver.segment(slot, False, spans)
                torch.cuda.synchronize()
            segments.append({"slot": slot, "frames": rec["frames"], "frame_info": driver.frame_info(slot)})
    ranges, device_ops = [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.name.startswith(_SPANS):
            if ev.device_type == DeviceType.CPU:
                ranges.append((ev.name, tr.start, tr.end))
        elif ev.device_type == DeviceType.CUDA:
            device_ops.append((ev.name, tr.start, tr.end))
    return reduce_events(ranges, device_ops, segments)
