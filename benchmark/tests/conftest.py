"""The CPU test scale of each configuration that `cells.TINY` does not
list yet, so that every cell runs in the parametrised tests of
`test_bench_reference.py` and `test_bench_control.py`."""

from benchmark.tests import cells

# `generator_scale` of a tiny lake: TPC-DS at 10 % of SF1 (288,040
# store_sales rows; the dimensions that do not grow with the scale keep
# their SF1 rows).
cells.TINY.setdefault("tpcds-sf1", 0.1)
