"""The port's attention == the JAX reference on the CPU: ``_quant`` bit for
bit, the causal and sliding masks, ``_sdpa`` (GQA, softcap), the query
chunks, ``full_attention`` whole and chunked, ``write_cache_prefill`` and
``decode_attention`` over float and int8 caches.

Weights, configs and tolerances are ``test_torch_contiguous.py``'s: the
float32 reduced configs, 1e-5 (abs and rel), and int8 codes held as its
docstring says.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.models import attention as ref_attn
from repro.models import transformer as ref_tr

from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models import transformer as tr
from test_torch_contiguous import (B, CHUNK, POS, S, _layer_input, _t, case,
                                   close, ref_cache, port_cache, same_cache)


def test_quant_is_bit_for_bit():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 9, 4, 64)) * rng.uniform(0.01, 30, (64, 9, 4, 1))
         ).astype(np.float32)
    x[0, 0, 0] = 0.0                        # an all-zero row: scale 1e-8
    x[1, 0, 0, :3] = [2.5, -2.5, 127.0]     # halves round to even
    for rdt, pdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        rq, rs = ref_attn._quant(jnp.asarray(x).astype(rdt))
        q, s = attn._quant(_t(x).to(pdt))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        assert q.dtype == torch.int8 and s.dtype == torch.float32


@pytest.mark.parametrize("sliding", [False, True])
def test_causal_mask(sliding):
    rcfg, pcfg, _, _ = case("gemma2-9b")
    rows = np.array([0, 5, 63, 64, 70, 71], np.int32)
    got = attn._causal_mask(pcfg, _t(rows), S, sliding)
    exp = ref_attn._causal_mask(rcfg, jnp.asarray(rows), S, sliding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert got[-1].sum() == (64 if sliding else 72)
    # no window in the config: the flag changes nothing
    _, qcfg, _, _ = case("qwen3-4b")
    assert torch.equal(attn._causal_mask(qcfg, _t(rows), S, True),
                       attn._causal_mask(qcfg, _t(rows), S, False))


@pytest.mark.parametrize("name", ["gemma2-9b", "qwen3-4b"])
def test_sdpa(name):
    """GQA grouping, the attention softcap (gemma2), a causal and a padded
    mask, and no mask."""
    rcfg, pcfg, _, _ = case(name)
    h, hk, dh = pcfg.n_heads, pcfg.n_kv_heads, pcfg.head_dim_
    rng = np.random.default_rng(2)
    q = rng.normal(size=(B, 9, h, dh)).astype(np.float32) * 3
    k = rng.normal(size=(B, 11, hk, dh)).astype(np.float32) * 3
    v = rng.normal(size=(B, 11, hk, dh)).astype(np.float32)
    causal = np.arange(11)[None] <= np.arange(2, 11)[:, None]
    pad = np.arange(11)[None, :] < np.array([4, 11])[:, None]
    for mask in (causal[None, None, None], pad[:, None, None, None], None):
        got = attn._sdpa(pcfg, _t(q), _t(k), _t(v),
                         None if mask is None else _t(mask))
        exp = ref_attn._sdpa(rcfg, jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v),
                             None if mask is None else jnp.asarray(mask))
        close(got, exp)


@pytest.mark.parametrize("name", ["gemma2-9b", "qwen3-4b"])
def test_sdpa_under_autograd(name):
    """With gradients recorded, ``_sdpa`` runs out of place: the same
    output, and the gradients of q, k, v equal the reference's."""
    import jax
    rcfg, pcfg, _, _ = case(name)
    h, hk, dh = pcfg.n_heads, pcfg.n_kv_heads, pcfg.head_dim_
    rng = np.random.default_rng(3)
    q = rng.normal(size=(B, 9, h, dh)).astype(np.float32) * 3
    k = rng.normal(size=(B, 11, hk, dh)).astype(np.float32) * 3
    v = rng.normal(size=(B, 11, hk, dh)).astype(np.float32)
    mask = (np.arange(11)[None] <= np.arange(2, 11)[:, None])[None, None,
                                                              None]
    g = rng.normal(size=(B, 9, h * dh)).astype(np.float32)
    qkv = [_t(a).requires_grad_() for a in (q, k, v)]
    got = attn._sdpa(pcfg, *qkv, _t(mask))
    (got * _t(g)).sum().backward()
    exp, vjp = jax.vjp(lambda *a: ref_attn._sdpa(rcfg, *a, jnp.asarray(mask)),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    close(got.detach(), exp)
    for t, e in zip(qkv, vjp(jnp.asarray(g))):
        close(t.grad, e)


def test_q_chunk():
    cfg = get_config("qwen3-4b")
    rcfg = ref_config("qwen3-4b")
    for chunk in (0, -1, 24, 100):
        for s in (72, 8192, 8200, 16384):
            pc = dataclasses.replace(cfg, attn_q_chunk=chunk)
            rc = dataclasses.replace(rcfg, attn_q_chunk=chunk)
            assert attn._q_chunk(pc, s) == ref_attn._q_chunk(rc, s)
    assert attn._q_chunk(cfg, 16384) == 1024     # auto: 16 chunks


@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["whole", "chunked"])
@pytest.mark.parametrize("name", ["gemma2-9b", "qwen1.5-32b", "qwen3-4b"])
def test_full_attention(name, chunk):
    """Layer 0 (local in gemma2) and layer 1 (global); unchunked and in 3
    query chunks (``attn_q_chunk``); qkv bias (qwen1.5-32b) made nonzero."""
    rcfg, pcfg, params, model = case(name, attn_q_chunk=chunk)
    x = _layer_input(pcfg)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    flags = tr.layer_flags(pcfg)
    for i in (0, 1):
        rp = ref_tr._tree_at(params["layers"], i)["attn"]
        pp = model.layers[i].attn
        if pcfg.qkv_bias:        # init_params starts biases at 0
            rp, pp = dict(rp), copy.deepcopy(pp)
            for b, seed in (("bq", 4), ("bk", 5), ("bv", 6)):
                r = np.random.default_rng(seed).normal(size=rp[b].shape)
                rp[b] = np.asarray(jnp.asarray(r).astype(rp[b].dtype))
                getattr(pp, b).copy_(M._from_numpy(rp[b]))
        sl = bool(flags["sliding"][i])
        got = attn.full_attention(pcfg, pp, _t(x), _t(pos), sl)
        exp = ref_attn.full_attention(rcfg, rp, jnp.asarray(x),
                                      jnp.asarray(pos), sl)
        for g, e in zip(got, exp):
            assert tuple(g.shape) == e.shape
            close(g, e)


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_write_cache_prefill(kv):
    """Identical k/v into a longer cache at row 1: equal bit for bit."""
    rcfg, pcfg, _, _ = case("qwen3-4b", kv_cache_dtype=kv)
    rng = np.random.default_rng(7)
    shape = (B, 5, pcfg.n_kv_heads, pcfg.head_dim_)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    exp = ref_attn.write_cache_prefill(rcfg, ref_cache(rcfg, B, 8), 1,
                                       jnp.asarray(k), jnp.asarray(v))
    cache = M.init_zeros(M.cache_specs(pcfg, B, 8), "cpu")
    got = attn.write_cache_prefill(pcfg, cache, 1, _t(k), _t(v))
    assert got is cache                     # written in place
    for n, e in exp.items():
        g = got[n].float() if got[n].dtype == torch.bfloat16 else got[n]
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(e).astype(g.numpy().dtype))


@pytest.mark.parametrize("name,kv", [("qwen3-4b", "float32"),
                                     ("qwen3-4b", "int8"),
                                     ("gemma2-9b", "int8")])
def test_decode_attention(name, kv):
    """One token against a filled cache at positions past the window, on a
    local and a global layer: the output and the written cache."""
    rcfg, pcfg, params, model = case(name, kv_cache_dtype=kv)
    rng = np.random.default_rng(8)
    shape = (B, S, pcfg.n_kv_heads, pcfg.head_dim_)
    rc = ref_cache(rcfg, B, S + 8)
    for i in range(pcfg.n_layers):
        rc = ref_attn.write_cache_prefill(
            rcfg, rc, i, jnp.asarray(rng.normal(size=shape), jnp.float32),
            jnp.asarray(rng.normal(size=shape), jnp.float32))
    x = rng.normal(size=(B, 1, pcfg.d_model)).astype(np.float32)
    flags = tr.layer_flags(pcfg)
    for i in (0, 1):
        sl = bool(flags["sliding"][i])
        cache = port_cache(rc)
        got, out_cache = attn.decode_attention(
            pcfg, model.layers[i].attn, _t(x), cache, i, _t(POS).long(), sl)
        exp, exp_cache = ref_attn.decode_attention(
            rcfg, ref_tr._tree_at(params["layers"], i)["attn"],
            jnp.asarray(x), rc, i, jnp.asarray(POS), sl)
        assert out_cache is cache
        close(got, exp, **same_cache(out_cache, exp_cache))


