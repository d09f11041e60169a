"""ara.h2d_gbps: the YET's bytes over the copies' CUDA-event windows
(the program's ``TenantTimeline.device_ms``), over the window's analyses."""


def read(rec):
    spans = [r["device"] for r in rec.get("runs", []) if r.get("device")]
    copy_ms = sum(s["copy_ms"] for s in spans)
    if not spans or copy_ms <= 0:
        return None
    return rec["yet_bytes"] * len(spans) / (copy_ms * 1e-3) / 1e9
