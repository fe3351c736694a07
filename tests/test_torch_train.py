"""Training on the port (``loss_fn`` under autograd, ``make_train_step``)
== the JAX reference on the CPU, for a tiny form of each of the ten
configs (two layers, d_model 64, vocab 128; float32 params and compute on
both sides), on the same weights (the port's ``init_params``, by the
reference's rules, carried into the reference's tree) and the same batch
made from a seed with numpy:

- ``loss_fn`` and every gradient against ``jax.value_and_grad(loss_fn)``,
  the port's backward run under ``torch.autograd.set_detect_anomaly`` (no
  in-place write to a tensor autograd saved, no NaN);
- 5 ``make_train_step`` steps against the reference's jitted train step,
  each from the reference's state before it: ``loss``, ``aux``, ``gnorm``,
  ``lr``, the parameters, both moments and the step counter after each;
- ``input_specs`` (every arch and shape) and ``param_spec_tree`` at full
  width, ``train_cell_specs``;
- remat on == off, and the port of tests/test_models.py's
  ``test_training_learns``.

Tolerances (measured, with their margins, beside each constant): the two
libraries sum in other orders, so gradients part by a few 1e-6 of their
leaf's largest entry; Adam divides each moment by its square root, so an
entry whose gradient is tiny moves by up to lr whatever its sign, and the
parameters are held to their leaf's scale.  Each step starts from the
reference's state, so the parts do not compound (rwkv6's ``ln_x`` turns
them into a 0.5% drift in 5 steps at lr 1e-2 otherwise).  zamba2's gradient is compared on 16 tokens: from 32 on,
the reference's masked ``where(tri, exp(diff), 0)`` has a NaN gradient
(0 * inf above the diagonal), which the port's masked-before-exp decay
does not (``test_hybrid_gradient_is_finite_where_the_references_is_nan``).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.steps import make_train_step, train_cell_specs
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.driver import load_checkpoint_tree

B = 2
SEQ = {"hybrid": 16}       # the rest: 64 (rwkv6: two chunks of 32)
# measured on the CPU, the largest part over the ten archs:
LOSS_TOL = 1e-5            # relative; loss 1.8e-7, loss/gnorm/lr 3.4e-6
GRAD_TOL = 1e-4            # of the leaf's largest entry; 1.9e-5 (zamba2)
MOMENT_TOL = 5e-4          # likewise; 4.7e-5 (rwkv6)
PARAM_TOL = 5e-3           # likewise; 8.5e-4 (zamba2), 2.3e-4 (qwen1.5 bk)
# eps 1e-5, not 1e-8: Adam's step mhat / (sqrt(nhat) + eps) is +-lr
# whatever the size of the gradient, so an entry whose gradient is
# rounding noise (|g| ~ 1e-9) moves by up to lr on either side; at eps 1e-8
# qwen1.5's zero-initialised key bias parts by 14% of its leaf
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10, eps=1e-5)
STEPS = 5


def tiny(cfg):
    """A two-layer float32 form of ``cfg``'s family (GQA kept where the
    config has it, a sliding window of 8 where it has one)."""
    c = cfg.reduced()
    kw = dict(n_layers=2, d_model=64, n_heads=2,
              n_kv_heads=1 if c.n_kv_heads < c.n_heads else 2, head_dim=32,
              d_ff=128, vocab_size=128, n_patches=8, ssm_state=8,
              ssm_head_dim=16, compute_dtype="float32",
              param_dtype="float32", remat=False)
    if c.sliding_window:
        kw["sliding_window"] = 8
    return dataclasses.replace(c, **kw)


def _batch(cfg, seed: int = 1, s: int | None = None) -> dict:
    """Labels with padding (-1), tokens (frames for the audio stub) and,
    for the vlm, patches: numpy, from a seed."""
    s = s or SEQ.get(cfg.family, 64)
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(-1, cfg.vocab_size, (B, s)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = (rng.normal(size=(B, s, cfg.d_model)) * 0.1
                         ).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, s)).astype(
            np.int32)
    if cfg.cross_attn_period:
        out["patches"] = (rng.normal(size=(B, cfg.n_patches, cfg.d_model))
                          * 0.1).astype(np.float32)
    return out


def _weights(cfg, seed: int = 0) -> dict:
    model = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return M.numpy_from_params(model)


def _grads(cfg, model, batch):
    """(loss, aux, gradients as the reference's tree) by autograd."""
    for p in model.parameters():
        p.requires_grad_(True)
    with torch.autograd.set_detect_anomaly(True):
        loss, m = M.loss_fn(cfg, model, batch, device="cpu")
        g = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True, materialize_grads=True)
    names = [k for k, _ in model.named_parameters()]
    return float(loss.detach()), float(m["aux"].detach()), M.stacked_tree(
        cfg, {k: v.numpy() for k, v in zip(names, g)})


def _close_tree(got: dict, exp: dict, tol: float, what: str) -> float:
    """Every leaf within ``tol`` of its largest entry (and ``tol``
    relative); returns the largest part found, in those units."""
    worst = 0.0
    gl = {k: v for k, v in M._flat(got).items()}
    el = {k: v for k, v in M._flat(exp).items()}
    assert gl.keys() == el.keys(), what
    for k in el:
        e, g = np.asarray(el[k]), np.asarray(gl[k])
        scale = max(float(np.abs(e).max()), 1e-30)
        worst = max(worst, float(np.abs(g - e).max()) / scale)
        np.testing.assert_allclose(g, e, rtol=tol, atol=tol * scale,
                                   err_msg=f"{what} {k}")
    return worst


# ----------------------------------------------------------- port alone


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_remat_on_equals_off(name):
    """``cfg.remat`` recomputes each layer in the backward: the loss and
    every gradient equal the run that keeps the activations, bit for bit
    on the CPU."""
    cfg = tiny(get_config(name))
    batch = _batch(cfg, 3)
    tree = _weights(cfg, 1)
    out = [_grads(c, M.params_from_numpy(c, tree, "cpu"), batch)
           for c in (cfg, dataclasses.replace(cfg, remat=True))]
    assert out[0][:2] == out[1][:2]
    for k, v in M._flat(out[0][2]).items():
        np.testing.assert_array_equal(M._flat(out[1][2])[k], v, err_msg=k)


def test_remat_recomputes_the_layers():
    """With remat the forward keeps only the layers' inputs: fewer saved
    tensors than without."""
    cfg = tiny(get_config("qwen3-4b"))
    batch = _batch(cfg, 3)
    counts = []
    for c in (cfg, dataclasses.replace(cfg, remat=True)):
        model = M.params_from_numpy(c, _weights(c), "cpu")
        for p in model.parameters():
            p.requires_grad_(True)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            M.loss_fn(c, model, batch, device="cpu")
        counts.append(len(saved))
    assert counts[1] < counts[0] / 2, counts


def test_train_step_leaves_prefill_and_decode_without_grad():
    cfg = tiny(get_config("qwen3-4b"))
    model = M.params_from_numpy(cfg, _weights(cfg), "cpu")
    step = make_train_step(cfg, AdamWConfig(**OPT), device="cpu")
    model, opt, m = step(model, adamw_init(model), _batch(cfg))
    assert all(p.requires_grad for p in model.parameters())
    assert set(m) == {"loss", "aux", "gnorm", "lr"}
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in m.values())
    logits, _ = M.prefill(cfg, model, {"tokens": _batch(cfg)["tokens"]},
                          M.init_zeros(M.cache_specs(cfg, B, 64), "cpu"),
                          device="cpu")
    assert not logits.requires_grad


def test_training_learns():
    """A few steps of the real train_step reduce the loss (the port of
    tests/test_models.py's case, same config and optimizer)."""
    cfg = dataclasses.replace(
        get_config("qwen3-4b").reduced(), n_layers=2, d_model=128, n_heads=2,
        n_kv_heads=2, head_dim=64, d_ff=256, vocab_size=128, remat=False)
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt_state = adamw_init(model)
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=2,
                                            total_steps=30), device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
    batch = {"tokens": tokens,   # fixed batch: memorization test
             "labels": np.concatenate([tokens[:, 1:], tokens[:, :1]], 1)}
    losses = []
    for _ in range(15):
        model, opt_state, metrics = step(model, opt_state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses
    assert all(np.isfinite(losses))


def test_train_step_runs_on_the_card_unless_told_otherwise():
    cfg = tiny(get_config("qwen3-4b"))
    if torch.cuda.is_available():
        make_train_step(cfg)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_train_step(cfg)
    model = M.params_from_numpy(cfg, _weights(cfg), "cpu")
    with pytest.raises(ValueError, match="lives on"):
        make_train_step(cfg, device="meta")(model, adamw_init(model),
                                            _batch(cfg))


# ------------------------------------------------------- against the reference

jax = pytest.importorskip("jax")   # the reference; absent where only the port runs
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.optim import AdamWConfig as RefAdamW  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402


def _reference(name: str):
    """The weights, the batch, and for each of STEPS steps of the
    reference's jitted train step: the loss, aux and gradients of
    ``value_and_grad(loss_fn)`` at the step's params (one program with the
    train step) and what the step returned.  Configs whose tiny forms are
    equal (qwen3-4b and qwen3-8b) share one run."""
    form = lambda n: dataclasses.replace(tiny(ref_config(n)),  # noqa: E731
                                         name="")
    return _reference_run(next(n for n in sorted(REF_ARCHS)
                               if form(n) == form(name)))


@functools.lru_cache(maxsize=None)
def _reference_run(name: str):
    rcfg = tiny(ref_config(name))
    tree, batch = _weights(tiny(get_config(name))), _batch(rcfg)
    step = ref_steps.make_train_step(rcfg, RefAdamW(**OPT))

    def both(p, o, b):
        (loss, m), g = jax.value_and_grad(
            lambda p: ref_model.loss_fn(rcfg, p, b), has_aux=True)(p)
        return (loss, m["aux"], g), step(p, o, b)

    fn = jax.jit(both)
    p = jax.tree.map(jnp.asarray, tree)
    o = ref_adamw_init(p)
    out = []
    for _ in range(STEPS):
        grad, (p, o, m) = fn(p, o, batch)
        out.append(jax.device_get({"grad": grad, "params": p, "opt": o,
                                   "metrics": m}))
    return tree, batch, out


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_loss_fn_and_grads_equal_the_references(name):
    cfg = tiny(get_config(name))
    tree, batch, ref = _reference(name)
    loss, aux, grads = _grads(cfg, M.params_from_numpy(cfg, tree, "cpu"),
                              batch)
    rloss, raux, rgrads = ref[0]["grad"]
    np.testing.assert_allclose(loss, float(rloss), rtol=LOSS_TOL)
    np.testing.assert_allclose(aux, float(raux), rtol=LOSS_TOL, atol=1e-7)
    _close_tree(grads, rgrads, GRAD_TOL, name)


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_train_step_equals_the_references(name):
    """Each of STEPS steps from the reference's state before it (the
    params and moments it reached, loaded into the port's model and
    optimizer state), so the parts are one step's, not a trajectory's."""
    cfg = tiny(get_config(name))
    tree, batch, ref = _reference(name)
    model = M.params_from_numpy(cfg, tree, "cpu")
    opt = adamw_init(model)
    step = make_train_step(cfg, AdamWConfig(**OPT), device="cpu")
    for i, r in enumerate(ref):
        if i:
            load_checkpoint_tree(cfg, {k: ref[i - 1][k]
                                       for k in ("params", "opt")},
                                 model, opt)
        model, opt, m = step(model, opt, batch)
        rm = r["metrics"]
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(rm[k]),
                                       rtol=LOSS_TOL, err_msg=k)
        np.testing.assert_allclose(float(m["aux"]), float(rm["aux"]),
                                   rtol=LOSS_TOL, atol=1e-7)
        assert int(opt["step"]) == int(r["opt"]["step"]) == i + 1
        _close_tree(M.numpy_from_params(model), r["params"], PARAM_TOL,
                    f"{name} step {i}")
        for k in ("mu", "nu"):
            got = M.stacked_tree(cfg, {n: t.numpy() for n, t in
                                       opt[k].items()})
            _close_tree(got, r["opt"][k], MOMENT_TOL, f"{name} {k} step {i}")


def test_hybrid_gradient_is_finite_where_the_references_is_nan():
    """A mamba block over 64 tokens: the same forward, and the port's
    gradient finite where the reference's is NaN (its decay
    where(tri, exp(cum_t - cum_s), 0) overflows above the diagonal and
    0 * inf is NaN; the port masks before the exp)."""
    from repro.models import mamba2 as ref_mamba
    from repro_torch.models import mamba2 as mamba
    cfg = tiny(get_config("zamba2-1.2b"))
    rcfg = tiny(ref_config("zamba2-1.2b"))
    tree = _weights(cfg)
    u = np.random.default_rng(2).normal(size=(1, 64, cfg.d_model)).astype(
        np.float32)
    rp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["ssm"])
    val, rg = jax.jit(jax.value_and_grad(lambda p, u: jnp.sum(
        ref_mamba.mamba_block(rcfg, p, u) ** 2)))(rp, jnp.asarray(u))
    ssm = M.params_from_numpy(cfg, tree, "cpu").layers[0].ssm
    for p in ssm.parameters():
        p.requires_grad_(True)
    out = (mamba.mamba_block(cfg, ssm, torch.from_numpy(u)) ** 2).sum()
    g = torch.autograd.grad(out, list(ssm.parameters()))
    np.testing.assert_allclose(float(out.detach()), float(val),
                               rtol=LOSS_TOL)
    assert not all(np.isfinite(np.asarray(x)).all()
                   for x in jax.tree.leaves(rg))
    assert all(bool(torch.isfinite(x).all()) for x in g)


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_specs_equal_the_references(name):
    """``input_specs`` of every shape the config runs, ``param_spec_tree``
    and ``train_cell_specs`` at full width: shapes, dtypes and logical
    axes, nothing allocated."""
    from repro.configs.base import shapes_for
    cfg, rcfg = get_config(name), ref_config(name)
    same = lambda t: jax.tree.map(  # noqa: E731
        lambda s: (tuple(s.shape), s.dtype, tuple(s.axes)), t,
        is_leaf=lambda x: isinstance(x, (ref_model.Spec, M.Spec)))
    for shape in shapes_for(rcfg):
        assert same(M.input_specs(cfg, shape)) == same(
            ref_model.input_specs(rcfg, shape)), shape
    assert same(M.param_spec_tree(cfg)) == same(ref_model.param_specs(rcfg))
    got = train_cell_specs(cfg, "train_4k")
    exp = ref_steps.train_cell_specs(rcfg, "train_4k")
    assert [same(t) for t in got] == [same(t) for t in exp]
