"""`Hyperspace.explain` in the port against the JAX package's, on the CPU.

Both packages index the same sample data and explain the same queries —
the filter and the join of `tests/test_plananalysis.py` — in every
display mode, verbose or not; the strings must be equal once each
package's warehouse root is masked. The display modes, the buffer
stream and the session state around explain behave as in the JAX
package.
"""

import os

import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

import hyperspace_tpu as jhs
from hyperspace_tpu.plan.expr import col as jcol

import hyperspace_tpu_torch as ths
from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.plan.expr import col
from hyperspace_tpu_torch.plananalysis.buffer_stream import BufferStream
from hyperspace_tpu_torch.plananalysis.display_mode import (ConsoleMode,
                                                            HTMLMode,
                                                            PlainTextMode,
                                                            get_display_mode)

# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)


def test_display_modes_and_custom_tags():
    assert PlainTextMode().highlight("x") == "<----x---->"
    assert "[32m" in ConsoleMode().highlight("x")
    assert HTMLMode().highlight("x").startswith("<b ")
    mode = get_display_mode(HyperspaceConf({
        "spark.hyperspace.explain.displayMode": "html",
        "spark.hyperspace.explain.displayMode.highlight.beginTag": "<mark>",
        "spark.hyperspace.explain.displayMode.highlight.endTag": "</mark>",
    }))
    assert isinstance(mode, HTMLMode)
    assert mode.highlight("x") == "<mark>x</mark>"
    assert mode.newline == "<br>"


def test_buffer_stream():
    stream = BufferStream(PlainTextMode())
    stream.write("a").write_line("b").highlight("c").write_line()
    assert stream.to_string() == "ab\n<----c---->\n"


@pytest.fixture
def pair(tmp_path, sample_parquet):
    """(port session, port facade, JAX session, JAX facade, source)."""
    conf = {"spark.hyperspace.index.num.buckets": "4",
            "spark.hyperspace.broadcast.threshold": "-1"}
    sess = ths.HyperspaceSession(ths.HyperspaceConf(
        {**conf, "spark.hyperspace.warehouse.dir": str(tmp_path / "wh")}),
        device="cpu")
    jsess = jhs.HyperspaceSession(jhs.HyperspaceConf({
        **conf, "spark.hyperspace.warehouse.dir": str(tmp_path / "jwh"),
        "spark.hyperspace.distribution.enabled": "false"}))
    return (sess, ths.Hyperspace(sess), jsess, jhs.Hyperspace(jsess),
            sample_parquet)


def _explain(hs, query, warehouse, **kw) -> str:
    out = []
    hs.explain(query, redirect=out.append, **kw)
    return out[0].replace(os.path.normpath(warehouse), "<WH>")


MODES = ["plaintext", "html", "console"]


@pytest.mark.parametrize("verbose", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_explain_filter_equals_jax(pair, tmp_path, mode, verbose):
    sess, hs, jsess, jhs_, src = pair
    for s in (sess, jsess):
        s.conf.set("spark.hyperspace.explain.displayMode", mode)
    hs.create_index(sess.read_parquet(src),
                    ths.IndexConfig("exIdx", ["clicks"], ["id"]))
    jhs_.create_index(jsess.read_parquet(src),
                      jhs.IndexConfig("exIdx", ["clicks"], ["id"]))
    got = _explain(hs, sess.read_parquet(src).filter(col("clicks") == 2)
                   .select("id"), str(tmp_path / "wh"), verbose=verbose)
    want = _explain(jhs_, jsess.read_parquet(src)
                    .filter(jcol("clicks") == 2).select("id"),
                    str(tmp_path / "jwh"), verbose=verbose)
    assert got == want
    assert "exIdx" in got and "Plan with indexes:" in got


@pytest.mark.parametrize("verbose", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_explain_join_equals_jax(pair, tmp_path, mode, verbose):
    sess, hs, jsess, jhs_, src = pair
    for s in (sess, jsess):
        s.conf.set("spark.hyperspace.explain.displayMode", mode)
    df, jdf = sess.read_parquet(src), jsess.read_parquet(src)
    for name, included in (("el", ["id"]), ("er", ["score"])):
        hs.create_index(df, ths.IndexConfig(name, ["imprs"], included))
        jhs_.create_index(jdf, jhs.IndexConfig(name, ["imprs"], included))
    got = _explain(hs, df.select("imprs", "id").join(
        df.select("imprs", "score"), on="imprs"), str(tmp_path / "wh"),
        verbose=verbose)
    want = _explain(jhs_, jdf.select("imprs", "id").join(
        jdf.select("imprs", "score"), on="imprs"), str(tmp_path / "jwh"),
        verbose=verbose)
    assert got == want
    if verbose and mode == "plaintext":
        # The stats table shows the Exchange and the Sort elided (2 -> 0).
        rows = got.splitlines()
        assert any("-2" in r for r in rows if "Exchange" in r)
        assert any("-2" in r for r in rows if r.startswith("| Sort"))


def test_explain_leaves_session_state(pair):
    sess, hs, _, _, src = pair
    query = sess.read_parquet(src).filter(col("clicks") == 2)
    sess.enable_hyperspace()
    hs.explain(query, redirect=lambda s: None)
    assert sess.is_hyperspace_enabled
    sess.disable_hyperspace()
    hs.explain(query, redirect=lambda s: None)
    assert not sess.is_hyperspace_enabled
