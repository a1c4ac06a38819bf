"""segcache.hit_rate (%): the device segment cache's hits over its hits
and misses in the window (`cache.segments.hits`, `cache.segments.misses`
of the port's registry)."""


def read(r):
    hits = r.counters.get("cache.segments.hits", 0.0)
    misses = r.counters.get("cache.segments.misses", 0.0)
    if hits + misses <= 0:
        return None
    return 100.0 * hits / (hits + misses)
