"""On the card only: the profiler's capture reads the card's timeline.
Skips without a CUDA card; run on the card with
`python -m pytest benchmark/tests/test_bench_card.py -m cuda`."""

import pytest

from benchmark.devtrace import Capture


@pytest.mark.cuda
def test_capture_reads_the_cards_timeline(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    cap = Capture(str(tmp_path / "trace.json"))
    cap.start()
    for _ in range(20):
        a = torch.tanh(a @ a / 2048)
    torch.cuda.synchronize()
    cap.stop()
    cap.export()
    t = cap.trace([])
    assert 0 < t.busy_s <= t.window_s
    assert t.top_ops(1)[0][1] > 0
