"""The command refuses to run without a card and prints no result; its
checks and the traced run's reading of the trace."""
import os
import shutil
import subprocess
import sys

import numpy as np

from portbench import spec, trace


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "covid-200M.w4-read-heavy", "--seed", str(2**31 + 3), "--seconds",
         "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=120, env=env)


def test_exits_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(spec.ROOT, env)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_exits_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    r = _run(tmp_path, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and r.stdout.strip() == ""


class _Ev:
    def __init__(self, name, start, dur, cuda=True, annotation=False):
        self._n, self._s, self._d = name, start, dur
        self._c, self._a = cuda, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._c else DeviceType.CPU

    def is_user_annotation(self):
        return self._a


class _Prof:
    def __init__(self, events):
        class K:
            def events(self_):
                return events

        class P:
            kineto_results = K()
        self.profiler = P()


def test_device_summary_reads_busy_idle_and_kernels():
    off = 10_000                   # the profiler's clock runs 10 us ahead
    ev = [_Ev(trace.MARK, 0 + off, 5, cuda=False, annotation=True),
          _Ev("(anonymous namespace)::fused_lookup_kernel((anonymous "
              "namespace)::Mirror, long const*)", 100 + off, 50),
          _Ev("void (anonymous namespace)::rank_kernel<4>(long const*, "
              "int)", 140 + off, 20),
          _Ev("scatter_kernel(long const*, int)", 400 + off, 100),
          _Ev("void at::native::_scatter_kernel(long)", 1100 + off, 9),
          _Ev("Memcpy HtoD (Pageable -> Device)", 850 + off, 200),
          _Ev("gets", 90 + off, 500, annotation=True)]
    spans = [(0, 100, "admission"), (100, 300, "gets"),
             (300, 600, "host_writes"), (600, 1000, "client")]
    s = trace.device_summary(_Prof(ev), 0, 1000, 0, spans, [(100, 600)])
    # busy: [100, 160) + [400, 500) + [850, 1000) (clipped)
    assert s["busy_s"] * 1e9 == 310 and s["window_s"] * 1e9 == 1000
    assert s["k1_events"] == 1 and s["k2_events"] == 2
    assert round(s["k1_device_s"] * 1e9) == 50
    idle = dict(s["idle_gaps"])
    assert round(idle["admission"] * 1e9) == 100
    assert round(idle["gets"] * 1e9) == 140
    assert round(idle["host_writes"] * 1e9) == 200
    assert round(idle["client"] * 1e9) == 250
    assert round(idle["engine_other"] * 1e9) == 0
    assert abs(idle["harness"]) < 1e-12
    assert s["device_ops"][0][0].startswith("Memcpy")
    assert np.isclose(sum(v for _, v in s["idle_gaps"]), 690e-9)
