"""telemetry.ms_per_query (ms/query): wall of the serving plane's
bookkeeping after each query's recorder finished (the span fold, the
critical-path stamp, registry histograms, SLO windows, rule-usage
counters, the flight ring) per query (`trace.telemetry.wall_s` over
`trace.queries`)."""


def read(r):
    queries = r.counters.get("trace.queries", 0.0)
    if queries <= 0:
        return None
    return 1000.0 * r.counters.get("trace.telemetry.wall_s", 0.0) / queries
