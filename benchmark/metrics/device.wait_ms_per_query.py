"""device.wait_ms_per_query (ms/query): self wall of the spans in which
the port's own code blocks the host on the card (stage compactions,
sizing reads, copies to the host) per query, from the port's span fold
(`trace.device_wait.wall_s` over `trace.queries`)."""


def read(r):
    queries = r.counters.get("trace.queries", 0.0)
    if queries <= 0:
        return None
    return 1000.0 * r.counters.get("trace.device_wait.wall_s", 0.0) / queries
