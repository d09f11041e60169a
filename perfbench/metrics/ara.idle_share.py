"""ara.idle_share: the share of the traced window in which no kernel,
copy or set ran on the card (``torch.profiler``), in %."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or "runs" not in rec:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
