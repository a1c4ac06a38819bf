"""join.bucketed_ms_per_query (ms/query): host wall of the co-bucketed
match of the shuffle-free join (the `join:bucketed` span, Δ`join.bucketed.s`
of the port's registry) per completed query."""


def read(r):
    if "join.bucketed.s" not in r.counters or r.completed <= 0:
        return None
    return 1000.0 * r.counters["join.bucketed.s"] / r.completed
