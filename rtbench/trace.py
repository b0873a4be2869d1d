"""The reduction of a ``torch.profiler`` trace of the window (device
activity only): device operations by name, the seconds in which any ran
(the union of their intervals), and the idle gaps between them named by
the benchmark's host span that was open when each began (``spans.py``;
the profiler stamps device activity on the wall clock, as the spans
are)."""

from __future__ import annotations

import bisect
import collections


def reduce(prof, host) -> dict:
    """{"ops": {name: [seconds, count]}, "busy_s", "gaps": {span:
    seconds}, "aligned"}; "busy_s" is None when the profiler recorded no
    device operation. ``host``: the spans' (start ns, end ns, name).
    "aligned" is the share of the device's busy time that lies within
    the spans' range, the check that the two clocks agree. Reads the
    profiler's raw events (the parsed event tree of ``prof.events()``
    takes minutes for a window of frames)."""
    dev = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and \
                not e.is_user_annotation():
            dev.append((e.start_ns(), e.end_ns(), e.name()))
    ops = collections.defaultdict(lambda: [0.0, 0])
    for s, t, name in dev:
        ops[name][0] += (t - s) * 1e-9
        ops[name][1] += 1
    if not dev:
        return {"ops": {}, "busy_s": None, "gaps": {}, "aligned": None}
    dev.sort()
    merged = []
    for s, t, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) * 1e-9
    host = sorted(host)
    starts = [h[0] for h in host]
    lo = starts[0] if starts else merged[0][0]
    hi = max((h[1] for h in host), default=merged[-1][1])
    inside = sum(max(0, min(t, hi) - max(s, lo)) for s, t in merged) * 1e-9
    gaps = collections.defaultdict(float)
    edges = [(lo, merged[0][0])] + [(merged[i][1], merged[i + 1][0])
                                    for i in range(len(merged) - 1)]
    for s, t in edges:
        if t <= s:
            continue
        # the spans follow one another, so only the last to open before
        # the gap can be open at its start
        i = bisect.bisect_right(starts, s) - 1
        name = host[i][2] if i >= 0 and host[i][1] > s else "outside spans"
        gaps[name] += (t - s) * 1e-9
    return {"ops": dict(ops), "busy_s": busy, "gaps": dict(gaps),
            "aligned": inside / busy if busy else None}


def device_seconds(red: dict, needle: str):
    """Seconds and launches of the device operations whose name holds
    ``needle``; None when none ran."""
    hits = [v for k, v in red["ops"].items() if needle in k]
    if not hits:
        return None
    return sum(v[0] for v in hits), sum(v[1] for v in hits)


def breakdown(red: dict, k: int = 10) -> dict:
    ops = sorted(red["ops"].items(), key=lambda kv: -kv[1][0])[:k]
    gaps = sorted(red["gaps"].items(), key=lambda kv: -kv[1])[:k]
    return {"device_ops": [[n[:120], v[0]] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps]}
