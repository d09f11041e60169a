"""ara.pipeline_gap_ms: an analysis's device span less the union of its
copy and kernel windows (CUDA events of ``TenantTimeline.device_ms``), the
mean over the window's analyses."""


def read(rec):
    spans = [r["device"] for r in rec.get("runs", []) if r.get("device")]
    if not spans or all(s["copy_ms"] == 0 for s in spans):
        return None
    return sum(s["span_ms"] - s["busy_ms"] for s in spans) / len(spans)
