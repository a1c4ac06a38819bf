"""TPC-DS: the seeded generator, the 99 queries on the DataFrame API and
their pandas oracles.

This is the port's own copy of the JAX package's `tpcds`: the generator
writes the same bytes for the same scale and seed, and the queries, the
oracles and the 13 index definitions (`queries.create_indexes`) are the
same. `QUERIES[name] = (build_fn, oracle_fn)`.
"""

from hyperspace_tpu_torch.tpcds.generator import generate, TABLES  # noqa: F401
from hyperspace_tpu_torch.tpcds.queries import QUERIES  # noqa: F401
