"""whatif.k1_roofline: the least time of the traced window's K1 calls
(``roofline/k1.py``, one over all trials a re-pricing) over the
profiler's time of its two kernels, in %."""


def read(rec):
    k1 = (rec.get("trace") or {}).get("k1")
    if not k1 or k1["kernel_s"] <= 0 or not k1["calls"]:
        return None
    return 100.0 * k1["bound_s"] / k1["kernel_s"]
