"""The port's LM sharding (``repro_torch.parallel.sharding``,
``launch.mesh``, ``launch.steps.shardings_for``, the MoE's grouped
dispatch) == the reference's.

* The rule cases of ``tests/test_sharding.py`` on the same ``FakeMesh``
  shapes, each held to the reference's ``spec_for`` as a tuple.
* ``spec_for`` under both tables for every leaf of ``param_spec_tree``,
  ``opt_state_specs`` and ``input_specs`` (every shape of a config: the
  batch, cache and state specs) of all ten configs, on the 16x16 and
  2x16x16 shapes, equal to the reference's (``shardings_for`` too).
* ``moe_ffn`` under a (data=2, model=2) context, so G = 4 dispatch
  groups, on the reduced qwen2-moe-a2.7b and granite-moe-1b-a400m in
  float32: output and aux loss within 1e-5 (``test_torch_contiguous``'s
  TOL) of the reference's under a ``ShardingContext`` over 4 forced host
  devices (run as a script through conftest's ``device_count``: the
  reference's ``shard_acts`` needs a real mesh), and the dropped (group,
  token, k) entries equal, exactly.  The dropped entries are read from a
  probe: weights under which expert e's output is ``silu(4) * unit(e)``,
  so a kept route of a token shows as a positive entry of its output.
* Without a context, or with one whose extent the batch cannot take
  (G falls to 1), ``moe_ffn`` is bit for bit what it is without groups.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

from repro.configs import get_config as ref_config
from repro.models import model as ref_M
from repro.models import moe as ref_moe
from repro.optim.adamw import opt_state_specs as ref_opt_specs
from repro.parallel import sharding as ref_sh

from repro_torch.configs import ARCHS, SHAPES, get_config, shapes_for
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.steps import replicated, shardings_for
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.optim import opt_state_specs
from repro_torch.parallel import sharding as sh
from repro_torch.tree import leaves_with_path

TOL = dict(atol=1e-5, rtol=1e-5)
MOE_ARCHS = ("qwen2-moe-a2.7b", "granite-moe-1b-a400m")
MOE_SHAPE = (4, 16)          # B divisible by G = 4: C = 6 a group, 24 at G = 1
LEAN = 28


class FakeMesh:
    """Shape-only stand-in so rule tests can use production axis sizes."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


PROD = FakeMesh({"data": 16, "model": 16})
PROD3 = FakeMesh({"pod": 2, "data": 16, "model": 16})

RULE_CASES = [   # tests/test_sharding.py's cases and their expected specs
    ((2048, 8192), ("embed", "mlp"), PROD, "PARAM_RULES", ("data", "model")),
    ((64, 2048, 1408), ("experts", "embed", "mlp"), PROD, "PARAM_RULES",
     ("model", "data", None)),
    ((60, 2048, 1408), ("experts", "embed", "mlp"), PROD, "PARAM_RULES",
     (None, "data", "model")),
    ((64, 128, 32768, 40, 128),
     ("layers", "kv_batch", "kv_seq", "kv_heads", None), PROD, "ACT_RULES",
     (None, "data", "model", None, None)),
    ((256, 4096), ("batch", None), PROD3, "ACT_RULES",
     (("pod", "data"), None)),
    ((1, 524288), ("batch", "seq"), PROD3, "ACT_RULES", (None, "model")),
    ((2, 64), ("batch", None), PROD3, "ACT_RULES", ("pod", None)),
]


@pytest.mark.parametrize("shape,axes,mesh,rules,exp", RULE_CASES)
def test_rule_cases_equal_the_references(shape, axes, mesh, rules, exp):
    got = sh.spec_for(shape, axes, mesh, getattr(sh, rules))
    assert got == tuple(ref_sh.spec_for(shape, axes, mesh,
                                        getattr(ref_sh, rules))) == exp
    assert sh.named_sharding(shape, axes, mesh,
                             params=rules == "PARAM_RULES") == (mesh, exp)


def test_rule_tables_equal_the_references():
    assert sh.PARAM_RULES == ref_sh.PARAM_RULES
    assert sh.ACT_RULES == ref_sh.ACT_RULES
    assert sh.INDEX_RULES == ref_sh.INDEX_RULES


def test_context_and_shard_acts_identity():
    x = torch.ones(4, 8)
    assert sh.shard_acts(x, "batch", None) is x
    assert sh.get_context() is None and sh.current_mesh() is None
    mesh = make_host_mesh(data=2, model=2, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    sh.set_context(sh.ShardingContext(mesh))
    try:
        assert sh.current_mesh() is mesh
        assert sh.get_context().mesh is mesh
        assert sh.shard_acts(x, "batch", None) is x
    finally:
        sh.set_context(None)
    assert replicated(mesh) == (mesh, ())


def test_meshes():
    prod, prod3 = (make_production_mesh(multi_pod=m) for m in (False, True))
    assert prod.shape == PROD.shape and prod3.shape == PROD3.shape
    assert prod3.axis_names == ("pod", "data", "model") and prod3.size == 512
    assert {d.type for d in prod3.devices} == {"meta"}
    mesh = make_host_mesh(data=2, pod=2, devices=["cpu"] * 5)
    assert mesh.shape == {"pod": 2, "data": 2, "model": 1}
    assert len(mesh.devices) == 4
    with pytest.raises(ValueError, match="needs 8"):
        make_host_mesh(data=4, model=2, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_host_mesh()


def _spec_trees(arch: str):
    """(name, reference tree, port tree) of every spec tree of a config."""
    rcfg, pcfg = ref_config(arch), get_config(arch)
    rp, pp = ref_M.param_specs(rcfg), M.param_spec_tree(pcfg)
    yield "params", rp, pp, True
    yield "opt", ref_opt_specs(rp, ref_M.Spec), opt_state_specs(pp, M.Spec), \
        True
    for s in shapes_for(pcfg):
        yield s, ref_M.input_specs(rcfg, SHAPES[s]), \
            M.input_specs(pcfg, SHAPES[s]), False


def _ref_leaves(tree) -> list:
    import jax
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, ref_M.Spec))[0]
    return [(jax.tree_util.keystr(p), s) for p, s in leaves]


def _spec_tuples(tree) -> list:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _spec_tuples(tree[k])]
    return [tree]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_trees_equal_the_references(arch):
    n = 0
    for name, rtree, ptree, params in _spec_trees(arch):
        ref = _ref_leaves(rtree)
        port = leaves_with_path(ptree)
        assert [p for p, _ in port] == [p for p, _ in ref], name
        for (path, ps), (_, rs) in zip(port, ref):
            assert (ps.shape, ps.dtype, ps.axes) == \
                (rs.shape, rs.dtype, rs.axes), (name, path)
        for mesh in (PROD, PROD3):
            for rules in ("PARAM_RULES", "ACT_RULES"):
                for (path, ps), (_, rs) in zip(port, ref):
                    got = sh.spec_for(ps.shape, ps.axes, mesh,
                                      getattr(sh, rules))
                    exp = ref_sh.spec_for(rs.shape, rs.axes, mesh,
                                          getattr(ref_sh, rules))
                    assert got == tuple(exp), (name, path, rules)
                    n += 1
            rules = ref_sh.PARAM_RULES if params else ref_sh.ACT_RULES
            assert _spec_tuples(shardings_for(ptree, mesh, params=params)) \
                == [tuple(ref_sh.spec_for(s.shape, s.axes, mesh, rules))
                    for _, s in ref], name
    assert n > 100


@pytest.mark.parametrize("axes,B", [({"data": 2, "model": 2}, 4),
                                    ({"data": 2, "model": 2}, 6),
                                    ({"data": 2, "model": 2}, 1),
                                    ({"pod": 2, "data": 16, "model": 16}, 256),
                                    ({"pod": 2, "data": 16, "model": 16}, 24),
                                    ({"data": 3, "model": 1}, 9)])
def test_dispatch_groups_equal_the_references(axes, B):
    mesh = FakeMesh(axes)
    assert moe._dispatch_groups(B) == ref_moe._dispatch_groups(B) == 1
    sh.set_context(sh.ShardingContext(mesh))
    ref_sh.set_context(ref_sh.ShardingContext(mesh))
    try:
        assert moe._dispatch_groups(B) == ref_moe._dispatch_groups(B)
    finally:
        sh.set_context(None)
        ref_sh.set_context(None)


# ------------------------------------------------------ the grouped dispatch
def _moe_case(arch: str, probe: bool):
    """(float32 reference config, numpy params, numpy x) from seeds.  With
    ``probe`` the experts' output is silu(4) * unit(e) for expert e (x's
    dim 0 is 1, the shared experts are zero), so a token's output is
    positive exactly at the experts its kept routes reach."""
    cfg = dataclasses.replace(ref_config(arch).reduced(),
                              param_dtype="float32", compute_dtype="float32")
    rng = np.random.default_rng(7 + probe)
    p = {}
    for k, (shape, _) in ref_moe.moe_param_specs(cfg).items():
        fan_in = shape[-2]
        p[k] = (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
    x = rng.normal(size=MOE_SHAPE + (cfg.d_model,)).astype(np.float32)
    # the first LEAN tokens lean towards expert 0: its queue overflows C in
    # groups 0 and 1 at G = 4, and C = 24 at G = 1
    r0 = p["router"][:, 0]
    x.reshape(-1, cfg.d_model)[:LEAN] += 4 * r0 / np.linalg.norm(r0)
    if probe:
        for k in p:
            if k != "router":
                p[k][...] = 0
        E = cfg.n_experts
        p["we_gate"][:, 0, 0] = 4.0
        p["we_up"][:, 0, 0] = 1.0
        p["we_down"][np.arange(E), 0, np.arange(E)] = 1.0
        x[..., 0] = 1.0
    return cfg, p, x


def _ref_moe(arch: str, probes=(False, True)) -> dict:
    """probe -> the reference's (y, aux) under the installed context."""
    import jax
    import jax.numpy as jnp
    # one fresh function for the context: it is read while tracing, so a
    # trace cached under another context would keep that one's groups
    fn = jax.jit(lambda cfg, p, x: ref_moe.moe_ffn(cfg, p, x),
                 static_argnums=0)
    out = {}
    for probe in probes:
        cfg, p, x = _moe_case(arch, probe)
        y, aux = fn(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x))
        out[probe] = (np.asarray(y), float(aux))
    return out


def _port_moe(arch: str, probe: bool, mesh=None):
    cfg, p, x = _moe_case(arch, probe)
    pcfg = dataclasses.replace(get_config(arch).reduced(),
                               param_dtype="float32", compute_dtype="float32")
    layer = moe.MoE(pcfg, torch.float32)
    with torch.no_grad():
        for k, t in layer.named_parameters():
            t.copy_(torch.from_numpy(p[k]))
    if mesh is not None:
        sh.set_context(sh.ShardingContext(mesh))
    try:
        y, aux = moe.moe_ffn(pcfg, layer, torch.from_numpy(x))
    finally:
        sh.set_context(None)
    return y, aux


def _dropped(y: np.ndarray, arch: str, G: int) -> set:
    """The (group, token, k) routes a probe run dropped."""
    cfg, p, x = _moe_case(arch, True)
    T = x.shape[0] * x.shape[1]
    probs = torch.softmax(torch.from_numpy(x.reshape(T, -1))
                          @ torch.from_numpy(p["router"]), -1)
    gate_i = torch.topk(probs, cfg.top_k, -1).indices.numpy()
    kept = y.reshape(T, -1)[np.arange(T)[:, None], gate_i] > 0
    TL = T // G
    return {(t // TL, t % TL, k) for t, k in zip(*np.nonzero(~kept))}


def _two_by_two():
    return make_host_mesh(data=2, model=2, devices=["cpu"] * 4)


_REF_GROUPED: dict = {}


@pytest.fixture
def ref_grouped(tmp_path_factory, device_count):
    """The reference's G = 4 outputs (and its G = 1 probe), from one
    subprocess with 4 forced host devices (this file run as a script),
    kept for the file's tests."""
    if not _REF_GROUPED:
        out = tmp_path_factory.mktemp("moe") / "ref.npz"
        device_count(4, __file__, str(out), timeout=600.0)
        _REF_GROUPED.update(np.load(out))
    return _REF_GROUPED


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_grouped_moe_equals_the_references(arch, ref_grouped):
    assert moe._capacity(get_config(arch).reduced(), 64) // 4 == 6
    y, aux = _port_moe(arch, False, _two_by_two())
    np.testing.assert_allclose(y.numpy(), ref_grouped[f"{arch}/y"], **TOL)
    np.testing.assert_allclose(float(aux), ref_grouped[f"{arch}/aux"], **TOL)
    # the dropped routes, exactly, beside one group's (G = 1)
    py, _ = _port_moe(arch, True, _two_by_two())
    got = _dropped(py.numpy(), arch, 4)
    assert got == _dropped(ref_grouped[f"{arch}/probe_y"], arch, 4)
    py1, _ = _port_moe(arch, True)
    one = _dropped(py1.numpy(), arch, 1)
    assert one == _dropped(ref_grouped[f"{arch}/probe_y1"], arch, 1)
    assert len(got) > len(one) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_without_groups_unchanged(arch):
    """G = 1 (no context, or a 2x2 context over a batch of one row) gives
    the same bits (``test_torch_moe.py`` holds G = 1 to the reference)."""
    cfg, p, x = _moe_case(arch, False)
    pcfg = dataclasses.replace(get_config(arch).reduced(),
                               param_dtype="float32", compute_dtype="float32")
    layer = moe.MoE(pcfg, torch.float32)
    with torch.no_grad():
        for k, t in layer.named_parameters():
            t.copy_(torch.from_numpy(p[k]))
    x1 = torch.from_numpy(x[:1])
    y0, a0 = moe.moe_ffn(pcfg, layer, x1)
    sh.set_context(sh.ShardingContext(_two_by_two()))
    try:
        assert moe._dispatch_groups(1) == 1
        y1, a1 = moe.moe_ffn(pcfg, layer, x1)
    finally:
        sh.set_context(None)
    assert torch.equal(y0, y1) and torch.equal(a0, a1)


def _remat_grads(cfg, batch, ctx, *, thread: bool):
    """loss and parameter gradients of reduced granite-moe (seed 3) under
    ``ctx``; with ``thread`` the backward runs on a fresh thread, where no
    context is installed, as autograd's device thread runs a CUDA
    backward."""
    import threading
    model = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    params = [p.requires_grad_() for p in model.parameters()]
    with sh.installed(ctx):
        loss, _ = M.loss_fn(cfg, model, batch, device="cpu")
    out = []
    run = lambda: out.append(torch.autograd.grad(loss, params))  # noqa: E731
    if thread:
        t = threading.Thread(target=run)
        t.start()
        t.join()
    else:
        with sh.installed(ctx):
            run()
    assert out, "the backward raised"
    return loss, out[0]


def test_remat_recompute_keeps_the_forwards_groups():
    """Under ``cfg.remat`` a layer is recomputed in the backward; the
    recomputation sees the forward's context (G = 4) even on a thread
    without one, so its gradients equal those of the kept activations."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              param_dtype="float32", compute_dtype="float32")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (4, 33))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ctx = sh.ShardingContext(_two_by_two())
    kept_loss, kept = _remat_grads(dataclasses.replace(cfg, remat=False),
                                   batch, ctx, thread=False)
    _, ungrouped = _remat_grads(dataclasses.replace(cfg, remat=False),
                                batch, None, thread=False)
    # the batch drops routes at G = 4 that G = 1 keeps: the test sees G
    assert any(not torch.equal(a, b) for a, b in zip(kept, ungrouped))
    loss, grads = _remat_grads(dataclasses.replace(cfg, remat=True), batch,
                               ctx, thread=True)
    assert torch.equal(loss, kept_loss)
    for a, b in zip(grads, kept):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def _reference_main(out: str) -> None:
    """Script mode: the reference's ``moe_ffn`` under a ShardingContext
    over a real (data=2, model=2) mesh of forced host devices."""
    import jax
    assert jax.device_count() >= 4, jax.device_count()
    # Auto axes (``jax.make_mesh``'s are Explicit here, which
    # ``with_sharding_constraint`` refuses)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    ref_sh.set_context(ref_sh.ShardingContext(mesh))
    res = {}
    try:
        for arch in MOE_ARCHS:
            got = _ref_moe(arch)
            res[f"{arch}/y"], aux = got[False]
            res[f"{arch}/aux"] = np.float32(aux)
            res[f"{arch}/probe_y"] = got[True][0]
    finally:
        ref_sh.set_context(None)
    for arch in MOE_ARCHS:                # one group: no context
        res[f"{arch}/probe_y1"] = _ref_moe(arch, (True,))[True][0]
    np.savez(out, **res)


if __name__ == "__main__":
    _reference_main(sys.argv[1])
