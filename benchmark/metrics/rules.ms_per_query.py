"""rules.ms_per_query (ms/query): self wall of the optimizer's spans (the
`optimize` span and one per rule application) per query, from the port's
span fold (`trace.rules.wall_s` over `trace.queries`)."""


def read(r):
    queries = r.counters.get("trace.queries", 0.0)
    if queries <= 0:
        return None
    return 1000.0 * r.counters.get("trace.rules.wall_s", 0.0) / queries
