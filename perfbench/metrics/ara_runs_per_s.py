"""ara_runs_per_s: analyses completed (year losses on the host) over the
whole window, which runs from the first analysis's start to the last one's
end."""


def read(rec):
    if "runs" not in rec or not rec["runs"]:
        return None
    return len(rec["runs"]) / rec["window_s"]
