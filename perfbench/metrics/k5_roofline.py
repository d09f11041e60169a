"""k5_roofline: the least time (``roofline/k5.py``) of the prefills
enqueued in the traced slice -- each one call a layer at its bucket and
width -- over the profiler's time of the FlashAttention kernels, in %."""
from roofline import k5


def read(rec):
    tr, sl = rec.get("trace"), rec.get("slice", {})
    if not tr or "start" not in sl or "stop" not in sl:
        return None
    a, b = sl["start"][0], sl["stop"][0]
    m = rec["model"]
    bound = sum(m["num_layers"] * k5.bound(
        p["width"], p["bucket"], p["bucket"], m["num_heads"],
        m["num_kv_heads"], m["head_dim"])[0]
        for p in rec["prefills"] if a <= p["t"] < b)
    spent = sum(s for name, s in tr["kernels_s"].items()
                if any(k in name for k in k5.KERNELS))
    if bound <= 0 or spent <= 0:
        return None
    return 100.0 * bound / spent
