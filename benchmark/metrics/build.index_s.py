"""build.index_s (s): host clock around the set-up's `create_index` calls,
each of which returns once its index files are written and committed.
In the traced run the profiler records those builds too."""


def read(r):
    return r.build_s if r.build_s > 0 else None
