"""The port's string-dictionary fingerprint (`parallel/spmd._dict_fingerprint`):
the segment-cache key of the LIKE masks and remap tables, computed once
per dictionary array and memoised by identity (`utils/identity.py`). A
warm device-lane LIKE serves both the fingerprint and the mask from
memory; equal dictionaries in distinct arrays still share one mask; the
digest is the one the JAX package computes on every call, and a
fingerprinted dictionary can no longer be written in place.
"""

import gc
import itertools
import sys
import threading
import weakref

import numpy as np
import pyarrow as pa
import pytest
import torch

from hyperspace_tpu.parallel.spmd import _dict_fingerprint as reference
from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.engine.compiler import apply_filter
from hyperspace_tpu_torch.io import segcache
from hyperspace_tpu_torch.io.columnar import from_arrow, to_arrow
from hyperspace_tpu_torch.parallel import spmd
from hyperspace_tpu_torch.plan import expr as E
from hyperspace_tpu_torch.utils.identity import IdentityMemo

CPU = torch.device("cpu")
FINGERPRINTS = "spmd.strings.fingerprints"
MEMO_HITS = "spmd.strings.fingerprint_memo_hits"
MASK_HITS = "spmd.strings.like_mask_cache_hits"


def _counts():
    reg = telemetry.get_registry()
    return {name: reg.counter(name).value
            for name in (FINGERPRINTS, MEMO_HITS, MASK_HITS)}


def _delta(before):
    after = _counts()
    return {name: after[name] - before[name] for name in before}


def _table(n=600, seed=5):
    rng = np.random.default_rng(seed)
    words = np.array(["special requests", "pending deposits", "regular",
                      "express accounts", "quickly final"])
    comments = [f"{words[a]} {b} {words[c]}" for a, b, c in
                zip(rng.integers(0, 5, n), rng.integers(0, 400, n),
                    rng.integers(0, 5, n))]
    return pa.table({"id": pa.array(np.arange(n, dtype=np.int64)),
                     "c": pa.array(comments)})


def _rows(batch):
    return to_arrow(batch).to_pylist()


PRED = E.col("c").like("%special%requests%")


def test_warm_like_fingerprints_the_dictionary_once():
    segcache.clear()
    table = _table()
    batch = from_arrow(table, device=CPU)
    want = _rows(apply_filter(from_arrow(table), PRED))  # host regex lane
    before = _counts()
    cold = _rows(apply_filter(batch, PRED))
    assert _delta(before) == {FINGERPRINTS: 1, MEMO_HITS: 0, MASK_HITS: 0}
    before = _counts()
    warm = _rows(apply_filter(batch, PRED))
    assert _delta(before) == {FINGERPRINTS: 0, MEMO_HITS: 1, MASK_HITS: 1}
    assert cold == warm == want and 0 < len(want) < table.num_rows


def test_equal_dictionaries_in_distinct_arrays_share_the_mask():
    segcache.clear()
    table = _table(seed=9)
    first, second = from_arrow(table, device=CPU), from_arrow(table,
                                                             device=CPU)
    d1, d2 = first.column("c").dictionary, second.column("c").dictionary
    assert d1 is not d2 and np.array_equal(d1, d2)
    assert spmd._dict_fingerprint(d1) == spmd._dict_fingerprint(d2)
    want = _rows(apply_filter(first, PRED))
    before = _counts()
    got = _rows(apply_filter(second, PRED))
    assert _delta(before) == {FINGERPRINTS: 0, MEMO_HITS: 1, MASK_HITS: 1}
    assert got == want


def test_freed_dictionary_is_fingerprinted_anew_at_a_reused_id():
    a = np.array(["alpha", "beta", "gamma"])
    spmd._dict_fingerprint(a)
    key = id(a)
    assert key in spmd._fingerprints._entries
    del a
    gc.collect()
    assert key not in spmd._fingerprints._entries  # it left with the array

    class _Gone:
        pass

    # A new array at an id whose slot still holds a memo of another
    # object: the slot is planted, since CPython gives no reused id on
    # demand.
    b = np.array(["delta", "epsilon"])
    gone = _Gone()
    spmd._fingerprints._entries[id(b)] = (weakref.ref(gone), (2, "stale"))
    del gone
    before = _counts()
    assert spmd._dict_fingerprint(b) == reference(b)
    assert _delta(before)[FINGERPRINTS] == 1
    before = _counts()
    assert spmd._dict_fingerprint(b) == reference(b)
    assert _delta(before) == {FINGERPRINTS: 0, MEMO_HITS: 1, MASK_HITS: 0}


@pytest.mark.parametrize("make", [
    lambda: np.array(["a", "bb", "special requests", "zz" * 17],
                     dtype="<U34"),
    lambda: np.array(["a", "b", "c", "d", "e", "f", "g"])[::2],
    lambda: np.array([], dtype="<U1"),
], ids=["unicode", "strided-view", "empty"])
def test_fingerprint_equals_the_unmemoised_definition(make):
    d = make()
    want = reference(d.copy())
    assert spmd._dict_fingerprint(d) == want
    before = _counts()
    assert spmd._dict_fingerprint(d) == want  # served from the memo
    assert _delta(before)[MEMO_HITS] == 1


@pytest.mark.parametrize("through", ["array", "base"])
def test_fingerprinted_dictionary_refuses_writes_in_place(through):
    base = np.array(["a", "b", "c", "d", "e", "f"])
    d = base if through == "array" else base[1:5]
    want = reference(d.copy())
    assert spmd._dict_fingerprint(d) == want
    with pytest.raises(ValueError, match="read-only"):
        (d if through == "array" else base)[2] = "zzz"
    assert spmd._dict_fingerprint(d) == want


def test_identity_memo_one_value_per_object_under_contention():
    memo = IdentityMemo()
    objs = [np.arange(i + 1) for i in range(64)]
    counter = itertools.count()
    seen = [[] for _ in objs]
    errors = []

    def work(seed):
        rng = np.random.default_rng(seed)
        try:
            for i in rng.integers(0, len(objs), 400):
                seen[i].append(memo.get(objs[i], lambda: next(counter))[0])
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(repr(exc))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,))
                   for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    firsts = [values[0] for values in seen if values]
    assert all(len(set(values)) <= 1 for values in seen)
    assert len(set(firsts)) == len(firsts)
