"""ara.host_ms: an analysis's wall time on the host less its device span
(the program's CUDA events on the staged path, the benchmark's own around
the step on the resident one), the mean over the window's analyses."""


def read(rec):
    runs = [r for r in rec.get("runs", []) if r.get("device")]
    if not runs:
        return None
    return sum((r["t_end"] - r["t_start"]) * 1e3 - r["device"]["span_ms"]
               for r in runs) / len(runs)
