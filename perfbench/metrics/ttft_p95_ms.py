"""ttft_p95_ms: the 95th percentile, over every request due in the window,
of its first token's arrival on the host less the time it was due.  A
request that failed, was refused or never answered counts as missing the
tail (infinitely late)."""
import math

from stats import percentile


def read(rec):
    rows = rec.get("requests")
    if not rows:
        return None
    waits = [(r["first"] - r["due"]) * 1e3 if r["outcome"] == "completed"
             else math.inf for r in rows]
    return percentile(waits, 95)
