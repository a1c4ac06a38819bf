"""engine.op_cpu_ms_per_query (ms/query): self thread-CPU of the physical
operators' spans and of the fused stages' dispatch and finalize per
query — the host's CPU cost of issuing the card's work — from the port's
span fold, over the queries that read the CPU clock
(`trace.operators.cpu_s` over `trace.query.cpu_sampled`)."""


def read(r):
    if r.counters.get("trace.queries", 0.0) <= 0:
        return None
    sampled = r.counters.get("trace.query.cpu_sampled", 0.0)
    if sampled <= 0:
        return None
    return 1000.0 * r.counters.get("trace.operators.cpu_s", 0.0) / sampled
