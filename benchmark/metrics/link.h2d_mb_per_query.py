"""link.h2d_mb_per_query (MB/query): bytes the transfer engine moved from
the host to the card in the window (`link.h2d.bytes`), in MB (10**6
bytes), per query completed."""


def read(r):
    if r.completed <= 0:
        return None
    return r.counters.get("link.h2d.bytes", 0.0) / 1e6 / r.completed
