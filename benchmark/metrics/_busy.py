"""Arithmetic on a profiled window (a frozen copy of the busy share in
``tools/profile_torch.py``'s ``_profile``): the device is busy where any
of its operations runs, so its busy time is the union of their
intervals, and its idle share is the rest of the window."""

from __future__ import annotations

import bisect

#: CUDA runtime and driver calls that launch work on the device.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")


def busy_union(spans) -> float:
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def merged(spans) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def is_launch(name: str) -> bool:
    """Whether a runtime call launches device work (its name or a
    versioned variant of it, ``cudaLaunchKernel_v7000``)."""
    return name in LAUNCH_CALLS or name.split("_v")[0] in LAUNCH_CALLS \
        or name.split("_ptsz")[0] in LAUNCH_CALLS


def idle_gaps(device_spans, host_ops, t0: float, t1: float,
              top: int = 10) -> list:
    """The device's idle time in [t0, t1], summed by what the host was
    doing when each idle gap began: the latest-starting host op that
    overlaps the gap (``host_ops``: (name, start, end)), or ``host idle``.
    → [[name, total gap length]], longest first, at most ``top``."""
    gaps, cur = [], t0
    for s, e in merged(device_spans):
        if s > cur:
            gaps.append((cur, min(s, t1)))
        cur = max(cur, e)
    if cur < t1:
        gaps.append((cur, t1))
    ops = sorted(host_ops, key=lambda o: o[1])
    starts = [o[1] for o in ops]
    totals = {}
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        name = "host idle"
        i = bisect.bisect_right(starts, g0) - 1
        for j in range(i, max(i - 200, -1), -1):
            if ops[j][2] >= g0:
                name = ops[j][0]
                break
        totals[name] = totals.get(name, 0.0) + (g1 - g0)
    return sorted(([k, v] for k, v in totals.items()),
                  key=lambda kv: -kv[1])[:top]


def top_ops(device_events, top: int = 10) -> list:
    """[[kernel name, summed time]] of the device ops that took most time
    (``device_events``: (name, start, end))."""
    totals = {}
    for name, s, e in device_events:
        totals[name] = totals.get(name, 0.0) + (e - s)
    return sorted(([k, v] for k, v in totals.items()),
                  key=lambda kv: -kv[1])[:top]
