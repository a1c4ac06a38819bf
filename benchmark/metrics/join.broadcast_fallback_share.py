"""join.broadcast_fallback_share (%): the share of the window's broadcast
joins whose keys did not fit the direct-address table, so that the
counting join ran (Δ`join.broadcast.fallbacks` over Δ`join.broadcast.calls`
of the port's registry); nothing where no broadcast join ran."""


def read(r):
    calls = r.counters.get("join.broadcast.calls", 0.0)
    if calls <= 0:
        return None
    return 100.0 * r.counters.get("join.broadcast.fallbacks", 0.0) / calls
