"""query.offcpu_share (%): the share of the queries' wall in the window
in which the thread running each query was on no CPU — waiting for the
interpreter lock, for its pool threads or for the card — from the root
spans of the port's span fold, over the queries that read the CPU clock:
100 x (1 - `trace.query.thread_cpu_s` / `trace.query.cpu_sampled_wall_s`)."""


def read(r):
    if r.counters.get("trace.queries", 0.0) <= 0:
        return None
    wall = r.counters.get("trace.query.cpu_sampled_wall_s", 0.0)
    if r.counters.get("trace.query.cpu_sampled", 0.0) <= 0 or wall <= 0:
        return None
    return 100.0 * (1.0 - r.counters.get("trace.query.thread_cpu_s", 0.0)
                    / wall)
