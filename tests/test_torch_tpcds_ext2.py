"""TPC-DS through the port on the CPU: the queries of `tpcds/queries_ext2.py`.

One seeded lake (`torch_suites.tpcds_lake`: scale 0.05, 8 buckets, the
13 indexes of `create_indexes`) serves the JAX package and the port's
host and torch lanes. Each query, rules on and rules off on each lane,
must equal the JAX package's rules-on result (float64 within rtol=1e-9:
sums add in another order) and the pandas oracle (rtol=1e-6, the bound of
`tests/test_tpcds.py`); its rules-on optimized logical plan must equal
the JAX package's, roots masked. The suite is split by query module into
four files so the parallel test run spreads it over its workers.
"""

import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

from hyperspace_tpu.tpcds import QUERIES as JQUERIES
from hyperspace_tpu_torch.tpcds.queries_ext2 import QUERIES_EXT2 as QUERIES

from torch_suites import check_tpcds_query, optimized_plan_texts, tpcds_lake

# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    return tpcds_lake(str(tmp_path_factory.mktemp("tpcds_ext2")),
                      jax_data=False)


@pytest.mark.parametrize("name", list(QUERIES))
def test_optimized_plan_equals_jax(lake, name):
    from hyperspace_tpu_torch.tpcds import QUERIES as PORT_QUERIES
    got, want = optimized_plan_texts(name, lake["host"], lake["jax"],
                                     PORT_QUERIES, JQUERIES, lake["root"])
    assert got == want


@pytest.mark.parametrize("lane", ["host", "torch"])
@pytest.mark.parametrize("name", list(QUERIES))
def test_query_equals_jax_and_oracle(lake, name, lane):
    check_tpcds_query(lake, name, lane, QUERIES, JQUERIES)
