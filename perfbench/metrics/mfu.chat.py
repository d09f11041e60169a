"""mfu.chat: the model FLOPs of every token the window processed -- each
admission prefill at its bucket and width (the program's ``admit.prefill``
spans) and each live decode row-step (the ``row_steps`` counter) reading
the keys its row's pages hold (the page pool's rows, read after every
scheduling step) -- over the window's length times the card's bf16 peak,
in %."""
from roofline import lm_step
from roofline.peaks import PEAKS


def read(rec):
    pool = rec.get("pool")
    if not pool or not rec.get("trace"):
        return None
    m, T, P = rec["model"], rec["window_s"], rec["page_size"]
    flops = sum(lm_step.prefill_flops(m, p["bucket"], p["width"])
                for p in rec["prefills"] if p["t"] < T)
    for (t0, s0, live, named), (t1, s1, _, _) in zip(pool, pool[1:]):
        if t1 <= T and live:
            flops += (s1 - s0) * lm_step.decode_flops(m, P * named / live)
    return 100.0 * flops / (T * PEAKS["bf16_flops_per_s"])
