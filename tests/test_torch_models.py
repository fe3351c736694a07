"""The port's dense-family layers == the JAX reference on the same weights
and inputs, and the carry-over of the reference's parameter tree.

Weights come from the reference's ``init_params`` (``jax.device_get``) and
reach the port through ``params_from_numpy``; inputs are numpy arrays from a
seed.  Everything computes in float32 on both sides.  Tolerance 1e-5 (abs
and rel): the two frameworks sum matrix products in other orders, and at
positions up to 4096 with theta = 1e6 the rotary angle is one float32
product on both sides, whose cos/sin the two libraries may round one ulp
apart.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import mlp as ref_mlp
from repro.models import model as ref_model
from repro.models.transformer import _tree_at

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import mlp as port_mlp
from repro_torch.models import model as M
from repro_torch.models.transformer import layer_param_specs, n_attn_layers

TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(**kw):
    base = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                d_ff=96, vocab_size=80, compute_dtype="float32",
                param_dtype="float32", **kw)
    return (dataclasses.replace(ref_config("qwen3-4b").reduced(), **base),
            dataclasses.replace(get_config("qwen3-4b").reduced(), **base))


def _pair(**kw):
    rcfg, pcfg = _cfgs(**kw)
    params = jax.device_get(ref_model.init_params(rcfg, jax.random.PRNGKey(3)))
    return rcfg, pcfg, params, M.params_from_numpy(pcfg, params, "cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, exp) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


def test_configs_are_the_references():
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_config(name))
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
            ref_config(name).reduced())
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("rwkv6-1.6b")


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 4
    s = rng.normal(size=(64,)).astype(np.float32) * 0.1
    _close(common.rms_norm(_t(x), _t(s), 1e-6),
           ref_common.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_to_4096(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 33, 4, 128)).astype(np.float32)
    pos = np.stack([np.arange(33) * 128, 4096 - np.arange(33)]
                   ).astype(np.int32)
    assert pos.max() == 4096
    _close(common.apply_rope(_t(x), _t(pos), theta),
           ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    np.testing.assert_array_equal(
        common.rope_freqs(128, theta), ref_common.rope_freqs(128, theta))


@pytest.mark.parametrize("variant", ["qk_norm", "qkv_bias"])
def test_project_qkv(variant):
    kw = ({} if variant == "qk_norm"
          else dict(qk_norm=False, qkv_bias=True))
    rcfg, pcfg, params, model = _pair(**kw)
    p = _tree_at(params["layers"], 1)["attn"]
    if variant == "qkv_bias":   # init_params starts biases at 0
        rng = np.random.default_rng(4)
        for b in ("bq", "bk", "bv"):
            p[b] = rng.normal(size=p[b].shape).astype(np.float32)
            getattr(model.layers[1].attn, b).copy_(_t(p[b]))
    x = np.random.default_rng(2).normal(size=(3, 1, 64)).astype(np.float32)
    exp = ref_attn._project_qkv(rcfg, p, jnp.asarray(x))
    got = attn._project_qkv(pcfg, model.layers[1].attn, _t(x))
    for g, e in zip(got, exp):
        assert tuple(g.shape) == e.shape
        _close(g, e)


def test_mlp_and_head():
    rcfg, pcfg, params, model = _pair()
    x = np.random.default_rng(5).normal(size=(3, 1, 64)).astype(np.float32)
    _close(port_mlp.mlp(pcfg, model.layers[0].ffn, _t(x)),
           ref_mlp.mlp(rcfg, _tree_at(params["layers"], 0)["ffn"],
                       jnp.asarray(x)))
    _close(M._head(pcfg, model, _t(x)),
           ref_model._head(rcfg, params, jnp.asarray(x)))
    rcfg, pcfg, params, model = _pair(tie_embeddings=True)
    assert "lm_head" not in dict(model.named_parameters())
    _close(M._head(pcfg, model, _t(x)),
           ref_model._head(rcfg, params, jnp.asarray(x)))


def test_act_fns_match_reference():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    for name in ("silu", "gelu", "relu"):
        _close(common.act_fn(name)(_t(x)),
               ref_common.act_fn(name)(jnp.asarray(x)))


def test_params_round_trip():
    rcfg, pcfg, params, model = _pair()
    back = M.numpy_from_params(model)
    flat_r = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_p = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat_r] == \
        [jax.tree_util.keystr(k) for k, _ in flat_p]
    for (_, a), (_, b) in zip(flat_r, flat_p):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(model.layers[1].attn.wq,
                       _t(params["layers"]["attn"]["wq"][1]))


def test_params_from_numpy_refuses_other_trees():
    rcfg, pcfg, params, _ = _pair()
    bad = jax.tree.map(lambda a: a, params)
    bad["layers"]["attn"]["wq"] = bad["layers"]["attn"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="shapes"):
        M.params_from_numpy(pcfg, bad, "cpu")
    bad = jax.tree.map(lambda a: a, params)
    del bad["lm_head"]
    with pytest.raises(ValueError, match="keys"):
        M.params_from_numpy(pcfg, bad, "cpu")


def test_init_params_follow_the_specs():
    rcfg, pcfg = _cfgs()
    model = M.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    specs = M.param_specs(pcfg)
    ref = jax.tree.map(lambda s: s.shape, ref_model.param_specs(rcfg),
                       is_leaf=lambda s: isinstance(s, ref_model.Spec))
    assert specs == ref
    tree = M.numpy_from_params(model)
    assert jax.tree.map(lambda a: a.shape, tree) == specs
    for name, p in model.named_parameters():
        if p.dim() == 1:
            assert not p.any(), name
        else:
            std = float(p.std()) * np.sqrt(p.shape[-2])
            assert 0.8 < std < 1.2, name
    assert layer_param_specs(pcfg).keys() == {"ln1", "attn", "ln2", "ffn"}
    assert n_attn_layers(pcfg) == pcfg.n_layers


def test_full_width_qwen3_4b_sizes():
    """qwen3-4b at full width: 4,411,424,256 parameters, 777,912,320 of
    them embed plus head (counted from the specs, nothing allocated)."""
    specs = M.param_specs(get_config("qwen3-4b"))
    sizes = jax.tree.leaves(jax.tree.map(
        lambda s: int(np.prod(s)), specs, is_leaf=lambda s: isinstance(
            s, tuple)))
    assert sum(sizes) == 4_411_424_256
    assert np.prod(specs["embed"]) + np.prod(specs["lm_head"]) == 777_912_320


def _n_params(specs: dict) -> int:
    return sum(jax.tree.leaves(jax.tree.map(
        lambda s: int(np.prod(s)), specs, is_leaf=lambda s: isinstance(
            s, tuple))))


@pytest.mark.parametrize("name,n", [("gemma2-9b", 10_159_209_984),
                                    ("qwen1.5-32b", 35_197_096_960),
                                    ("qwen2-moe-a2.7b", 14_315_587_584)])
def test_full_width_sizes(name, n):
    """Parameters of the other full-width configs the port serves, counted
    from the specs with nothing allocated, equal to the reference's."""
    specs = M.param_specs(get_config(name))
    assert _n_params(specs) == n
    ref = jax.tree.map(lambda s: s.shape,
                       ref_model.param_specs(ref_config(name)),
                       is_leaf=lambda s: isinstance(s, ref_model.Spec))
    assert specs == ref


def test_other_families_are_refused():
    cfg = dataclasses.replace(get_config("qwen3-4b"), family="ssm")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.DenseLM(cfg)
