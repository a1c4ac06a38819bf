"""TPC-H on the framework DataFrame API.

The reference pins "all TPC-H and TPC-DS queries serializable" through its
plan layer (`index/serde/package.scala:46-49`); here the 22 TPC-H queries
run end to end — built, optimized (index rules), executed — with pandas
oracles asserting 3-way result equality. This is the port's own copy of
the JAX package's `tpch`: the generator writes the same bytes for the same
scale and seed.
"""

from hyperspace_tpu_torch.tpch.generator import generate  # noqa: F401
from hyperspace_tpu_torch.tpch.queries import QUERIES  # noqa: F401
