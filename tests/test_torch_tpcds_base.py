"""TPC-DS through the port on the CPU: the forty-two queries of `tpcds/queries.py` itself.

One seeded lake (`torch_suites.tpcds_lake`: scale 0.05, 8 buckets, the
13 indexes of `create_indexes`) serves the JAX package and the port's
host and torch lanes. Each query, rules on and rules off on each lane,
must equal the JAX package's rules-on result (float64 within rtol=1e-9:
sums add in another order) and the pandas oracle (rtol=1e-6, the bound of
`tests/test_tpcds.py`); its rules-on optimized logical plan must equal
the JAX package's, roots masked. The suite is split by query module into
four files so the parallel test run spreads it over its workers.

This file also holds the generator to the JAX package's bytes.
"""

import filecmp
import os

import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

from hyperspace_tpu.tpcds import QUERIES as JQUERIES
from hyperspace_tpu_torch.tpcds import QUERIES as ALL
from hyperspace_tpu_torch.tpcds.queries_ext import QUERIES_EXT
from hyperspace_tpu_torch.tpcds.queries_ext2 import QUERIES_EXT2
from hyperspace_tpu_torch.tpcds.queries_ext3 import QUERIES_EXT3

# The queries `queries.py` defines itself (it merges the three extension
# modules' dictionaries into QUERIES).
QUERIES = {name: q for name, q in ALL.items()
           if name not in QUERIES_EXT and name not in QUERIES_EXT2
           and name not in QUERIES_EXT3}

from torch_suites import check_tpcds_query, optimized_plan_texts, tpcds_lake

# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    return tpcds_lake(str(tmp_path_factory.mktemp("tpcds_base")),
                      jax_data=True)


def test_generator_writes_the_jax_packages_bytes(lake):
    for name, path in lake["paths"].items():
        assert filecmp.cmp(os.path.join(path, "part-0.parquet"),
                           os.path.join(lake["jax_paths"][name],
                                        "part-0.parquet"), shallow=False)


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


@pytest.mark.parametrize("name", list(ALL))
def test_chip_smoke_index_table_matches_jax_plans(lake, name):
    """`chip_smoke.py` pins, per query, the indexes the rules-on plan reads
    (the card's machine has no JAX): the table must name what the JAX
    package's optimized plan reads, and the port's plan must agree."""
    from hyperspace_tpu.engine.executor import _scalar_subqueries

    from chip_smoke import TPCDS_INDEXES_READ, indexes_read

    def jax_read(plan):
        names = {leaf.index_name for leaf in plan.collect_leaves()
                 if leaf.index_name}
        for sub in _scalar_subqueries(plan):
            names |= jax_read(sub.execution_plan())
        return names

    jsess, jdfs = lake["jax"]
    sess, dfs = lake["host"]
    jsess.enable_hyperspace()
    sess.enable_hyperspace()
    try:
        want = sorted(jax_read(jsess.optimize(JQUERIES[name][0](jdfs).plan)))
        got = sorted(indexes_read(sess.optimize(ALL[name][0](dfs).plan)))
    finally:
        jsess.disable_hyperspace()
        sess.disable_hyperspace()
    assert TPCDS_INDEXES_READ.get(name, []) == want
    assert got == want
