"""The port's runtime (``repro_torch.runtime``): the seven cases of
tests/test_runtime.py (straggler detection, elastic planning, the training
driver's crash/restart determinism and straggler-triggered re-shard) on
the port, on the CPU; then against the JAX reference: the port's
``TrainDriver`` trajectory == the reference's from the same initial params
(float32 compute), and a checkpoint written by either package resumed by
the other, its continued losses equal to the writer's own run."""
import dataclasses
import shutil

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import (SimCluster, StragglerDetector, TrainDriver,
                                 TrainRunConfig, plan_elastic_remesh)


def tiny_cfg(get=get_config, **kw):
    return dataclasses.replace(
        get("qwen3-4b").reduced(), n_layers=2, d_model=128, n_heads=2,
        n_kv_heads=2, head_dim=64, d_ff=256, vocab_size=256, remat=False,
        **kw)


class TestStraggler:
    def test_detects_slow_worker(self):
        cl = SimCluster(8, seed=0)
        det = StragglerDetector(k=3.0)
        for _ in range(10):
            assert det.observe(cl.step_times()) == []
        cl.inject_straggler(3, factor=25.0)
        assert det.observe(cl.step_times()) == [3]

    def test_detects_dead_worker(self):
        cl = SimCluster(4, seed=0)
        det = StragglerDetector()
        det.observe(cl.step_times())
        cl.inject_failure(2)
        assert 2 in det.observe(cl.step_times())


class TestElasticPlan:
    def test_shrink_keeps_global_batch(self):
        plan = plan_elastic_remesh(global_batch=256, dp_size=16,
                                   failed_ranks=[3])
        # 15, 14, ... don't divide 256; largest feasible dp is 8
        assert plan is not None and plan.new_dp == 8
        assert plan.new_dp * plan.per_device_batch == 256

    def test_no_failures_no_change(self):
        plan = plan_elastic_remesh(256, 16, [])
        assert plan is not None and not plan.changed

    def test_infeasible_returns_none(self):
        assert plan_elastic_remesh(7, 1, [0]) is None


class TestDriver:
    def test_crash_restart_is_deterministic(self, tmp_path):
        """A crash + restart converges to the SAME final loss as an
        uninterrupted run (the checkpoint restores params, optimizer AND
        the loader cursor; replayed steps are bit-identical on the CPU)."""
        opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=16)
        base = dict(steps=16, ckpt_every=4, batch=2, seq_len=64)
        r_plain = TrainDriver(
            tiny_cfg(), TrainRunConfig(**base, ckpt_dir=str(tmp_path / "a")),
            opt, device="cpu").train()
        r_crash = TrainDriver(
            tiny_cfg(), TrainRunConfig(**base, fail_at=10,
                                       ckpt_dir=str(tmp_path / "b")),
            opt, device="cpu").train()
        assert "failure@10" in r_crash["events"]
        assert "restart@8" in r_crash["events"]
        np.testing.assert_allclose(r_plain["final_loss"],
                                   r_crash["final_loss"], rtol=1e-6)
        assert r_crash["losses"][8:10] == r_crash["losses"][10:12]

    def test_straggler_triggers_elastic(self, tmp_path):
        run = TrainRunConfig(steps=12, ckpt_every=6, batch=4, seq_len=32,
                             dp_size=4, straggler_at=5,
                             ckpt_dir=str(tmp_path / "c"))
        res = TrainDriver(tiny_cfg(), run, device="cpu").train()
        assert any(e.startswith("elastic@") for e in res["events"])
        assert np.isfinite(res["final_loss"])


def test_launch_train_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu``: the reference's
    flags and JSON summary; without ``--device`` it wants the card."""
    import json
    import torch
    from repro_torch.launch.train import main
    main(["--device", "cpu", "--preset", "tiny", "--steps", "6",
          "--ckpt-every", "2", "--fail-at", "3", "--seq", "32",
          "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    res = json.loads(out[out.index("{"):])
    assert res["events"] == ["failure@3", "restart@2"]
    assert res["steps"] == 6 and np.isfinite(res["final_loss"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--preset", "tiny", "--steps", "1"])


# ------------------------------------------------------- against the reference

jax = pytest.importorskip("jax")   # the reference; absent where only the port runs
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.optim import AdamWConfig as RefAdamW  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro.runtime import TrainDriver as RefDriver  # noqa: E402
from repro.runtime import TrainRunConfig as RefRun  # noqa: E402

F32 = dict(compute_dtype="float32")
RUN = dict(steps=10, ckpt_every=5, batch=2, seq_len=64)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
# measured: the two trajectories part by at most 2.0e-7 relative over 10
# steps (the libraries sum in other orders)
TRAJ_TOL = 1e-5


def _weights() -> dict:
    import torch
    cfg = tiny_cfg(**F32)
    return M.numpy_from_params(
        M.init_params(cfg, torch.Generator().manual_seed(3), "cpu"))


def _port(ckpt_dir, **run) -> TrainDriver:
    cfg = tiny_cfg(**F32)
    drv = TrainDriver(cfg, TrainRunConfig(**{**RUN, **run},
                                          ckpt_dir=str(ckpt_dir)),
                      AdamWConfig(**OPT), device="cpu")
    tree = _weights()

    def init():
        model = M.params_from_numpy(cfg, tree, "cpu")
        return model, adamw_init(model)

    drv._init_state = init
    return drv


def _ref(ckpt_dir, **run) -> RefDriver:
    drv = RefDriver(tiny_cfg(ref_config, **F32),
                    RefRun(**{**RUN, **run}, ckpt_dir=str(ckpt_dir)),
                    RefAdamW(**OPT))
    tree = _weights()

    def init():
        params = jax.tree.map(jnp.asarray, tree)
        return params, ref_adamw_init(params)

    drv._init_state = init
    return drv


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's uninterrupted runs, each writing
    checkpoints at steps 5 and 10."""
    base = tmp_path_factory.mktemp("runs")
    return (base, _ref(base / "ref").train(), _port(base / "port").train())


def test_trajectory_equals_the_references(runs):
    _, ref, port = runs
    assert port["events"] == ref["events"] == []
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=TRAJ_TOL)


def _resume_from(src, dst):
    """``dst`` holding only ``src``'s checkpoint of step 5."""
    dst.mkdir()
    shutil.copytree(src / "step_00000005", dst / "step_00000005")
    return dst


def test_port_resumes_the_references_checkpoint(runs, tmp_path):
    base, ref, _ = runs
    res = _port(_resume_from(base / "ref", tmp_path / "d"),
                fail_at=0).train()
    assert res["events"] == ["failure@0", "restart@5"]
    np.testing.assert_allclose(res["losses"], ref["losses"][5:],
                               rtol=TRAJ_TOL)


def test_reference_resumes_the_ports_checkpoint(runs, tmp_path):
    base, _, port = runs
    res = _ref(_resume_from(base / "port", tmp_path / "e"),
               fail_at=0).train()
    assert res["events"] == ["failure@0", "restart@5"]
    np.testing.assert_allclose(res["losses"], port["losses"][5:],
                               rtol=TRAJ_TOL)


def test_checkpoint_manifests_equal(runs):
    """Both packages write the same names, shapes and dtypes."""
    import json
    base, _, _ = runs
    man = [json.loads((base / who / "step_00000010" / "manifest.json")
                      .read_text()) for who in ("ref", "port")]
    assert man[0]["extra"] == man[1]["extra"]
    assert {p: (e["shape"], e["dtype"], e["shard"], e["entry"])
            for p, e in man[0]["entries"].items()} == {
        p: (e["shape"], e["dtype"], e["shard"], e["entry"])
        for p, e in man[1]["entries"].items()}
