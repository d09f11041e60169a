"""prefix_hit_share: pages an admission mapped onto pages already held
(the page pool's ``pages_shared``) over all the pages it took (shared and
freshly allocated), over the window, in %."""


def read(rec):
    c = rec.get("counters")
    if not c:
        return None
    shared = c["end"]["pages_shared"] - c["start"]["pages_shared"]
    fresh = c["end"]["pages_allocated"] - c["start"]["pages_allocated"]
    if shared + fresh == 0:
        return None
    return 100.0 * shared / (shared + fresh)
