"""Shared arithmetic of the metric readers in ``metrics/``. A reader returns
None where its run holds nothing to read, and the metric is left out."""

from __future__ import annotations

from . import peaks, work


def per_request(run, span: str, scale: float = 1.0):
    """The span's seconds summed over the window, per request, times ``scale``."""
    s = run.spans.get(span)
    if not s or not run.requests:
        return None
    return sum(s) / len(run.requests) * scale


def latency_quantile(run, q: float):
    """The q-quantile (nearest rank) of every request's latency, in seconds."""
    lat = sorted(t1 - t0 for t0, t1, _ in run.requests)
    if not lat:
        return None
    return lat[max(0, -(-int(q * 1000) * len(lat) // 1000) - 1)]


def roofline_pct(run, family: str):
    """100 x the sum of each traced call's bound over the device time of the
    family's kernels in the same requests; None without calls, time or a peak
    for the card."""
    prof = run.profile
    if prof is None or run.device == "cpu":
        return None
    import torch

    peak = peaks.peak(torch.cuda.get_device_name(0))
    calls = prof.family_calls(family)
    spent = prof.kernel_s.get(family, 0.0)
    if peak is None or not calls or spent <= 0:
        return None
    bound = sum(n * work.bound_s(kernel, shape, peak) for (kernel, shape), n in calls.items())
    return 100.0 * bound / spent


def idle_pct(run):
    prof = run.profile
    if prof is None or not prof.window_s or prof.busy_s is None:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)
