"""whatif.host_ms: a re-pricing's wall time on the host less the device
span of its step (the benchmark's CUDA events around the call), the mean
over the window's re-pricings."""


def read(rec):
    runs = [r for r in rec.get("runs", []) if r.get("device")]
    if not runs:
        return None
    return sum((r["t_end"] - r["t_start"]) * 1e3 - r["device"]["span_ms"]
               for r in runs) / len(runs)
