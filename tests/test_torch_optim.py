"""The port's optimizer (``repro_torch.optim``) == the JAX reference's on
the CPU: the five cases of tests/test_optim.py on the port, and
``cosine_schedule``, ``clip_by_global_norm``, ``adamw_update`` and
``compress_grads`` against the reference's on random trees made from a
seed with numpy (float32 within 1e-6 relative: the two libraries round
``pow``, ``sqrt`` and the fused multiply-adds apart by an ulp at most)."""
import numpy as np
import pytest
import torch

from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, compress_grads,
                               compressor_init, cosine_schedule,
                               opt_state_specs)
from repro_torch.tree import leaves

TOL = dict(rtol=1e-6, atol=1e-7)


def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=5,
                      total_steps=200)
    target = {"w": torch.tensor([3.0, -2.0, 0.5]), "b": torch.tensor(4.0)}
    params = {k: torch.zeros_like(v) for k, v in target.items()}
    state = adamw_init(params)
    for _ in range(200):
        grads = {k: params[k] - target[k] for k in params}
        params, state, _ = adamw_update(cfg, params, grads, state)
    err = max(float((params[k] - target[k]).abs().max()) for k in params)
    assert err < 0.05, err
    assert int(state["step"]) == 200 and state["step"].dtype == torch.int32


def test_clip_by_global_norm():
    grads = {"a": torch.full((4,), 10.0), "b": torch.full((4,), 10.0)}
    clipped, gnorm = clip_by_global_norm(grads, 1.0)
    assert abs(float(gnorm) - np.sqrt(8 * 100)) < 1e-3
    total = sum(float(g.square().sum()) for g in leaves(clipped))
    assert abs(np.sqrt(total) - 1.0) < 1e-3


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(cosine_schedule(cfg, torch.tensor(s))) for s in range(101)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1.0) < 1e-6
    assert lrs[100] <= 0.1 + 1e-6
    assert all(a >= b - 1e-9 for a, b in zip(lrs[10:], lrs[11:]))  # monotone


def test_error_feedback_compression_convergent():
    """int8 EF compression: SGD on a quadratic still converges, and the
    residuals stay bounded (the EF invariant)."""
    target = torch.from_numpy(np.linspace(-2, 2, 64).astype(np.float32))
    w = torch.zeros(64)
    resid = compressor_init({"w": w})["w"]
    for _ in range(400):
        g = w - target
        gq, resid = (t["w"] for t in compress_grads({"w": g}, {"w": resid}))
        w = w - 0.1 * gq
    assert float((w - target).abs().max()) < 0.05
    assert float(resid.abs().max()) < 1.0


def test_compression_preserves_scale():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32))}
    dq, e2 = compress_grads(g, compressor_init(g))
    # dequantized + residual == original (exact EF identity)
    np.testing.assert_allclose((dq["w"] + e2["w"]).numpy(), g["w"].numpy(),
                               atol=1e-5)


# ------------------------------------------------------- against the reference

jax = pytest.importorskip("jax")   # the reference; absent where only the port runs
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import compress as ref_compress  # noqa: E402

# jitted: one program each instead of an eager compile per op and shape
_ref_update = jax.jit(ref_adamw.adamw_update, static_argnums=0)
_ref_clip = jax.jit(ref_adamw.clip_by_global_norm, static_argnums=1)
_ref_compress = jax.jit(ref_compress.compress_grads)


def _tree(seed: int, scale: float = 1.0) -> dict:
    """A nested tree of float32 arrays (numpy), the shapes of a small
    model's leaves."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)  # noqa
    return {"embed": f(16, 8), "final_norm": f(8),
            "layers": {"attn": {"wq": f(2, 8, 8), "wk": f(2, 8, 4)},
                       "ln1": f(2, 8)}, "step_like": [f(3), f(5, 2)]}


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(port, ref, **tol):
    for p, r in zip(leaves(port), jax.tree.leaves(ref)):
        np.testing.assert_allclose(np.asarray(p), np.asarray(r),
                                   **(tol or TOL))


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (100, 100)])
def test_cosine_schedule_equals_the_references(warmup, total):
    cfg = AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    rcfg = ref_adamw.AdamWConfig(lr=3e-4, warmup_steps=warmup,
                                 total_steps=total)
    for s in (0, 1, 5, warmup, warmup + 1, total // 2, total, total + 7):
        got = cosine_schedule(cfg, torch.tensor(s, dtype=torch.int32))
        exp = ref_adamw.cosine_schedule(rcfg, jnp.asarray(s, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(exp), **TOL)


@pytest.mark.parametrize("scale,max_norm", [(1.0, 1.0), (0.01, 1.0),
                                            (3.0, 0.5)])
def test_clip_by_global_norm_equals_the_references(scale, max_norm):
    g = _tree(1, scale)
    got, gnorm = clip_by_global_norm(_torch(g), max_norm)
    exp, rnorm = _ref_clip(jax.tree.map(jnp.asarray, g), max_norm)
    np.testing.assert_allclose(float(gnorm), float(rnorm), **TOL)
    _close(got, exp)


def test_adamw_update_equals_the_references():
    """Ten steps from the same params, grads fed from the same seeds (the
    reference's grads each step); params, both moments, step and lr."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=10)
    rcfg = ref_adamw.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=10)
    p0 = _tree(2)
    params = _torch(p0)
    state = adamw_init(params)
    rparams = jax.tree.map(jnp.asarray, p0)
    rstate = ref_adamw.adamw_init(rparams)
    for i in range(10):
        g = _tree(10 + i, 0.1)
        params, state, lr = adamw_update(cfg, params, _torch(g), state)
        rparams, rstate, rlr = _ref_update(
            rcfg, rparams, jax.tree.map(jnp.asarray, g), rstate)
        np.testing.assert_allclose(float(lr), float(rlr), **TOL)
        assert int(state["step"]) == int(rstate["step"]) == i + 1
        _close(params, rparams)
        _close(state["mu"], rstate["mu"])
        _close(state["nu"], rstate["nu"])


def test_adamw_keeps_a_bfloat16_parameter_in_bfloat16():
    """A bfloat16 parameter is updated in float32 and rounded back, as the
    reference's ``pf.astype(p.dtype)``; its moments stay float32."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    rcfg = ref_adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    p = np.random.default_rng(3).normal(size=(4, 8)).astype(np.float32)
    g = np.random.default_rng(4).normal(size=(4, 8)).astype(np.float32)
    params = {"w": torch.from_numpy(p).to(torch.bfloat16)}
    state = adamw_init(params)
    params, state, _ = adamw_update(
        cfg, params, {"w": torch.from_numpy(g).to(torch.bfloat16)}, state)
    rp = {"w": jnp.asarray(p).astype(jnp.bfloat16)}
    rp, rstate, _ = ref_adamw.adamw_update(
        rcfg, rp, {"w": jnp.asarray(g).astype(jnp.bfloat16)},
        ref_adamw.adamw_init(rp))
    assert params["w"].dtype == torch.bfloat16
    assert state["mu"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(params["w"].float().numpy(),
                                  np.asarray(rp["w"], np.float32))
    _close(state["nu"], rstate["nu"])


def test_opt_state_specs_equal_the_references():
    from repro.models import model as ref_model
    from repro_torch.models import model as M
    spec = lambda s: M.Spec(s.shape, s.dtype, s.axes)  # noqa: E731
    ref = jax.tree.map(spec, ref_adamw.opt_state_specs(
        {"w": ref_model.Spec((4, 8), "bfloat16", ("embed", None))},
        ref_model.Spec), is_leaf=lambda x: isinstance(x, ref_model.Spec))
    got = opt_state_specs({"w": M.Spec((4, 8), "bfloat16", ("embed", None))},
                          M.Spec)
    assert got == ref


@pytest.mark.parametrize("seed", [5, 6])
def test_compress_grads_equals_the_references(seed):
    g, e = _tree(seed), _tree(seed + 100, 0.01)
    dq, e2 = compress_grads(_torch(g), _torch(e))
    rdq, re2 = _ref_compress(jax.tree.map(jnp.asarray, g),
                             jax.tree.map(jnp.asarray, e))
    _close(dq, rdq, rtol=1e-6, atol=1e-6)
    _close(e2, re2, rtol=1e-6, atol=1e-6)
