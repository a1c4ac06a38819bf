"""The one generator of query streams: a traffic file's parameters and a
seed in, one list of query names per client out."""

from __future__ import annotations

from typing import List

import numpy as np

KINDS = ("closed-rotation",)


def stream_orders(traffic: dict, seed: int) -> List[List[str]]:
    """`closed-rotation`: one permutation of the mix's `queries` is drawn
    from the seed, and client i of `streams` runs it from position
    floor(i * len / streams) on, cycling until the window ends. Each client
    has an order of its own; together they spread over the whole mix, so a
    window shorter than a client's cycle still runs every query about
    equally often, whatever the seed."""
    if traffic["loop"] not in KINDS:
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    queries = list(traffic["queries"])
    rng = np.random.default_rng(int(seed) % (2 ** 63))
    order = [queries[i] for i in rng.permutation(len(queries))]
    n, clients = len(order), int(traffic["streams"])
    return [order[i * n // clients:] + order[:i * n // clients]
            for i in range(clients)]
