"""decode_step_ms: the device time of the decode rounds collected over the
window and its drain (the program's CUDA events, ``round_ms``) over their
steps."""


def read(rec):
    ms = rec.get("round_ms")
    if not ms:
        return None
    return sum(ms) / (len(ms) * rec["inner_steps"])
