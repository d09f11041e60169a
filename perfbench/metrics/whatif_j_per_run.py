"""whatif_j_per_run: the card's energy over the window (NVML's total-energy
counter) over the resident path's re-pricings completed in it."""


def read(rec):
    if rec.get("energy_j") is None or not rec.get("runs"):
        return None
    return rec["energy_j"] / len(rec["runs"])
