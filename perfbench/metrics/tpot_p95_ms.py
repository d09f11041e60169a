"""tpot_p95_ms: the 95th percentile, over the completed requests due in the
window, of (last token's time - first token's time) / (tokens - 1): the
streaming speed a user sees."""
from stats import percentile


def read(rec):
    rows = [r for r in rec.get("requests", [])
            if r["outcome"] == "completed" and r["n"] > 1]
    if not rows:
        return None
    return percentile([(r["last"] - r["first"]) * 1e3 / (r["n"] - 1)
                       for r in rows], 95)
