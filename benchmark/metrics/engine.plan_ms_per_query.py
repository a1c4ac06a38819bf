"""engine.plan_ms_per_query (ms/query): self wall of physical planning
(`plan:physical`) and of each fused stage's program preparation
(`fusion:prepare`) per query, from the port's span fold
(`trace.plan.wall_s` over `trace.queries`)."""


def read(r):
    queries = r.counters.get("trace.queries", 0.0)
    if queries <= 0:
        return None
    return 1000.0 * r.counters.get("trace.plan.wall_s", 0.0) / queries
