"""k3_roofline: the least time (``roofline/k3.py``) of the paged decode
calls in the traced slice over the profiler's time of the decode kernel,
in %.  The live row-steps come from the program's ``row_steps`` counter,
read after every scheduling step; each reads the pages its row's page
table names (the page pool's rows, read at the step before), one call a
layer."""
from roofline import k3
from roofline.peaks import PEAKS


def row_step_pages(pool, a, b):
    """(row-steps, pages those row-steps read) between times a and b."""
    steps = pages = 0.0
    for (t0, s0, live, named), (t1, s1, _, _) in zip(pool, pool[1:]):
        if a <= t0 and t1 <= b and live:
            steps += s1 - s0
            pages += (s1 - s0) * named / live
    return steps, pages


def read(rec):
    tr, sl = rec.get("trace"), rec.get("slice", {})
    if not tr or "start" not in sl or "stop" not in sl:
        return None
    m, P = rec["model"], rec["page_size"]
    steps, pages = row_step_pages(rec.get("pool", []), sl["start"][0],
                                  sl["stop"][0])
    spent = sum(s for name, s in tr["kernels_s"].items()
                if any(k in name for k in k3.KERNELS))
    if steps <= 0 or spent <= 0:
        return None
    H, Hkv, D = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    # per call: the named pages' K, V and positions, and per row its
    # table, position, q and output (roofline/k3.py with C = 1, NB = 1)
    per_row = k3.nbytes(1, 0, P, H, Hkv, D)
    nbytes = m["num_layers"] * (pages * (k3.nbytes(1, 1, P, H, Hkv, D)
                                         - k3.nbytes(1, 0, P, H, Hkv, D))
                                + steps * per_row)
    flops = m["num_layers"] * pages * k3.flops(1, 1, P, H, Hkv, D)
    bound = max(nbytes / PEAKS["hbm_bytes_per_s"],
                flops / PEAKS["bf16_flops_per_s"])
    return 100.0 * bound / spent
