"""On the card: a small run of every cell through the timed path, traced,
is correct and reads every per-layer metric its cell lists.  Skips without
a card (decided inside the test).  20,000,000 keys (W4: a sample of
1,000,000): few enough to load in seconds, enough that no overlay reaches
its compaction threshold in four steps (a compaction reseeds the pack, and
K2's reading then stays silent).
"""
import time

import pytest
import torch

from portbench import check, spec
from portbench.tests.small import cells, small_cell


@pytest.mark.gpu
@pytest.mark.parametrize("name", cells())
def test_small_traced_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import index_serving
    c = small_cell(name, keys=20_000_000)
    out = index_serving.run(c, 2**31 + 21, 1.0, True, "cuda:0",
                            time.perf_counter(), steps=4)
    assert check.correct(out["counts"]), out["counts"]
    tr = out["trace"]
    assert 0 < tr["device"]["busy_s"] < tr["device"]["window_s"]
    for m in c.per_layer:
        v = spec.reader(m["name"])(tr)
        assert v is not None and v > 0, m["name"]
        if m["unit"] == "%":
            assert v <= 100, (m["name"], v)
