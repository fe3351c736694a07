"""On the card: the program's spans and the profiler's trace share one
clock through the tracer's anchor.  Each K1 launch (the ``cudaLaunchKernel``
call the profiler correlates with a ``fused_lookup_kernel``), moved onto
the host clock by ``anchor_ns`` (``tracing.anchor_offset``: the shortest of
the tracer's anchor ranges, so within half of it), lies inside its step's
``gets.launch`` span within 20 us.  Skips without a card (decided inside
the test)."""
import numpy as np
import pytest
import torch

from portbench.trace import K1_KERNEL

SLACK_NS = 20_000
STEPS = 6


@pytest.mark.gpu
def test_k1_launches_map_inside_their_launch_spans():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Aulid, BlockDevice
    from repro_torch.core.workloads import make_dataset, payloads_for
    from repro_torch.serving import IndexEngine
    from repro_torch.serving.tracing import anchor_offset, span_mask
    keys = make_dataset("covid", 1_000_000, seed=5)
    idx = Aulid(BlockDevice())
    idx.bulkload(keys, payloads_for(keys))
    eng = IndexEngine(idx, device="cuda:0")
    rng = np.random.default_rng(5)

    def step():
        for k in rng.choice(keys, 4096):
            eng.get(int(k))
        eng.step()
    step()                               # builds K1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.start_trace()
        for _ in range(STEPS):
            step()
        exp = eng.stop_trace().export()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    offset = anchor_offset(events, exp["anchor_ns"])
    k1 = {e.correlation_id() for e in events
          if e.device_type() == DeviceType.CUDA and K1_KERNEL.match(e.name())}
    launches = sorted(
        (e.start_ns() - offset, e.start_ns() + e.duration_ns() - offset)
        for e in events if e.device_type() != DeviceType.CUDA
        and e.name().startswith(("cudaLaunch", "cuLaunch"))
        and e.correlation_id() in k1)
    sp = exp["spans"]
    m = span_mask(exp, "gets.launch")
    spans = sorted(zip(sp["start_ns"][m].tolist(), sp["end_ns"][m].tolist()))
    assert len(spans) == STEPS and launches, (spans, launches)
    held = set()
    for s, e in launches:
        at = [i for i, (a, b) in enumerate(spans)
              if a - SLACK_NS <= s and e <= b + SLACK_NS]
        assert len(at) == 1, (s, e, spans)
        held.update(at)
    assert held == set(range(STEPS))
