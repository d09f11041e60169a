"""prefill_ms_per_ktok: the admission prefills' CUDA-event milliseconds
(``ContinuousBatchingEngine.prefill_ms``) over the thousands of tokens they
prefilled (bucket times width, from the program's ``admit.prefill`` spans),
over the window and its drain."""


def read(rec):
    calls = [p for p in rec.get("prefills", []) if p["ms"] is not None]
    tokens = sum(p["bucket"] * p["width"] for p in calls)
    if not calls or tokens == 0:
        return None
    return sum(p["ms"] for p in calls) / (tokens / 1e3)
