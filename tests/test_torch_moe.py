"""The port's MoE FFN and the moe family's contiguous-cache paths == the
JAX reference on the CPU, for the reduced forms of granite-moe-1b-a400m and
qwen2-moe-a2.7b (shared experts), in float32 with the tolerances of
``test_torch_contiguous.py`` (1e-5).

``moe_ffn`` routes by ``top_k`` of the router's softmax; inputs are drawn
so that no two probabilities of a token tie (the two libraries may break a
tie between experts apart).  Capacity follows the token count (one dispatch
group), so a batch of many tokens drops some where a decode step drops
none, on both sides.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

import jax
import jax.numpy as jnp

from repro.models import moe as ref_moe
from repro.models.transformer import _tree_at

from repro_torch.configs import get_config
from repro_torch.models import moe
from test_torch_contiguous import (MOE, case, check_forward,
                                   check_prefill_and_decode,
                                   check_stack_decode, check_stack_forward,
                                   close)


def _route(p: dict, x: np.ndarray) -> np.ndarray:
    """The router's probabilities (T, E), checked free of ties."""
    probs = np.asarray(jax.nn.softmax(
        jnp.asarray(x.reshape(-1, x.shape[-1]))
        @ jnp.asarray(p["router"], jnp.float32), -1))
    assert (np.diff(np.sort(probs, -1), axis=-1) > 0).all()
    return probs


@pytest.mark.parametrize("shape", [(2, 40), (3, 1)], ids=["prefill", "decode"])
@pytest.mark.parametrize("name", MOE)
def test_moe_ffn(name, shape):
    """Output and aux loss of layer 1's FFN on a prompt-sized batch, whose
    first 24 tokens lean towards expert 0 so that its queue overflows the
    capacity (the drop bin), and on a decode-sized one (no drops)."""
    rcfg, pcfg, params, model = case(name)
    p = _tree_at(params["layers"], 1)["ffn"]
    x = np.random.default_rng(5).normal(
        size=shape + (pcfg.d_model,)).astype(np.float32) * 2
    r0 = np.asarray(p["router"], np.float32)[:, 0]
    x.reshape(-1, pcfg.d_model)[:24] += 4 * r0 / np.linalg.norm(r0)
    T = x.shape[0] * x.shape[1]
    load = np.bincount(np.argsort(-_route(p, x), -1)[:, :pcfg.top_k].ravel(),
                       minlength=pcfg.n_experts)
    assert (load.max() > moe._capacity(pcfg, T)) == (T > 3)
    ey, eaux = jax.jit(ref_moe.moe_ffn, static_argnums=0)(
        rcfg, p, jnp.asarray(x))
    gy, gaux = moe.moe_ffn(pcfg, model.layers[1].ffn, torch.from_numpy(x))
    close(gy, ey)
    close(gaux, eaux)


@pytest.mark.parametrize("name", MOE)
def test_capacity(name):
    cfg = get_config(name)
    for n in (1, 8, 100, 16384, 32768):
        assert moe._capacity(cfg, n) == ref_moe._capacity(cfg, n)
        assert moe._capacity(cfg.reduced(), n) == ref_moe._capacity(
            cfg.reduced(), n)
    assert moe._capacity(cfg, 8) == 8 and moe._capacity(cfg, 32768) > 8


def test_shared_experts_are_an_mlp():
    """qwen2-moe-a2.7b's shared experts: one dense FFN of width
    n_shared * d_ff under the ``shared_`` names."""
    _, pcfg, _, model = case("qwen2-moe-a2.7b")
    names = dict(model.layers[0].ffn.named_parameters())
    assert {k for k in names if k.startswith("shared_")} == {
        "shared_w_gate", "shared_w_up", "shared_w_down"}
    assert names["shared_w_up"].shape == (pcfg.d_model,
                                          pcfg.n_shared_experts * pcfg.d_ff)
    _, gcfg, _, gmodel = case("granite-moe-1b-a400m")
    assert not any(k.startswith("shared_")
                   for k, _ in gmodel.layers[0].ffn.named_parameters())


@pytest.mark.parametrize("name", MOE)
def test_stack_forward_fills_the_cache(name):
    check_stack_forward(name)


@pytest.mark.parametrize("name", MOE)
def test_stack_decode(name):
    check_stack_decode(name)


@pytest.mark.parametrize("name", MOE)
def test_forward(name):
    check_forward(name)


@pytest.mark.parametrize("name", MOE)
def test_prefill_and_decode_steps(name):
    check_prefill_and_decode(name)
