"""device.idle_share (%): the share of the traced stretch of the window in
which no kernel, memcpy or memset ran on the card."""


def read(r):
    t = r.window_trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
