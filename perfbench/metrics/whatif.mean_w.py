"""whatif.mean_w: the card's mean power over the resident path's window,
from NVML's total-energy counter."""


def read(rec):
    if rec.get("energy_j") is None or "runs" not in rec:
        return None
    return rec["energy_j"] / rec["window_s"]
