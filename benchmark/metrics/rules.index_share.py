"""rules.index_share (%): the share of the window's completed queries that
a rule served from at least one index (Δ`rules.queries_served` of the
port's registry over the completed queries). Results stay correct when
the rules stop firing; this reads that they did."""


def read(r):
    if "rules.queries_served" not in r.counters or r.completed <= 0:
        return None
    return 100.0 * r.counters["rules.queries_served"] / r.completed
