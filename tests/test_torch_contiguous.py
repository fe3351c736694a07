"""The port's contiguous-cache paths == the JAX reference on the CPU: the
layer stack, ``forward``, ``prefill`` and ``decode_step`` (float and int8
caches), for the reduced form of every registered dense config (the moe
configs in ``test_torch_moe.py``, attention alone in
``test_torch_attention.py``), and the step functions of
``launch/steps.py``.

Weights come from the reference's ``init_params`` and reach the port through
``params_from_numpy``; inputs are numpy arrays from a seed.  Each config
computes in float32 (``compute_dtype="float32"``); its parameters keep the
config's dtype, and a bfloat16 KV cache becomes float32, so that the cache
does not round two float32 values 1e-7 apart into bfloat16 values 4e-3
apart.  gemma2-9b and qwen1.5-32b keep their int8 cache.

Tolerances: 1e-5 (abs and rel) in float32, as in ``test_torch_models.py``;
the hidden states before the final norm grow with depth (an RMS of about 3
after 4 gemma2 layers), so there the absolute part is 1e-5 times their RMS.
``_quant`` is bit for bit on identical inputs.  Where an int8 cache is
filled from k/v that the two packages computed 1e-7 apart, a value lying at
a rounding boundary may take the neighbouring code: there the codes may
differ by one at no more than 0.1% of the entries (the scales stay within
1e-5), and each decode step starts from the reference's cache, so both
packages quantize only the new token.  Where a code of the new token did
part, the outputs after it are held within 2e-3 (one int8 step of one k or
v entry moved gemma2's reduced stack by 9.7e-4); everywhere else within
1e-5.  The bfloat16 case holds logits within 0.1 and the greedy tokens
equal.
"""
import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.models import attention as ref_attn
from repro.models import model as ref_model
from repro.models import transformer as ref_tr

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import steps
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models import transformer as tr
from repro_torch.serving.paged_model import init_page_pool, paged_decode_step

TOL = dict(atol=1e-5, rtol=1e-5)
FLIP_TOL = dict(atol=2e-3, rtol=1e-5)
DENSE = sorted(n for n, c in ARCHS.items() if c.family == "dense")
MOE = sorted(n for n, c in ARCHS.items() if c.family == "moe")
# past the reduced gemma2's 64-token window, and 3 query chunks of 24
B, S, CHUNK = 2, 72, 24
POS = np.array([S, S + 3], np.int32)      # the decode step's positions


def _float32(cfg):
    kw = dict(compute_dtype="float32", remat=False)
    if cfg.kv_cache_dtype != "int8":
        kw["kv_cache_dtype"] = "float32"
    return dataclasses.replace(cfg, **kw)


@functools.lru_cache(maxsize=None)
def _weights(name: str):
    """The reference's params for the reduced ``name`` and the port's model
    holding them (shared by every variant of the config)."""
    rcfg = _float32(ref_config(name).reduced())
    params = jax.device_get(ref_model.init_params(rcfg,
                                                  jax.random.PRNGKey(0)))
    return params, M.params_from_numpy(_float32(get_config(name).reduced()),
                                       params, "cpu")


def case(name: str, **kw):
    """(reference config, port config, reference params, port model) for
    the float32 reduced form of ``name``, with ``kw`` replaced."""
    rcfg = dataclasses.replace(_float32(ref_config(name).reduced()), **kw)
    pcfg = dataclasses.replace(_float32(get_config(name).reduced()), **kw)
    return (rcfg, pcfg) + _weights(name)


def tokens(cfg, seed=1, shape=(B, S)) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got: torch.Tensor, exp, *, scaled=False, **tol) -> None:
    exp = np.asarray(exp, np.float32)
    tol = tol or dict(TOL)
    if scaled:
        tol["atol"] *= float(np.sqrt(np.mean(exp ** 2)))
    np.testing.assert_allclose(got.float().numpy(), exp, **tol)


def same_cache(got: dict, exp: dict) -> dict:
    """The cache within TOL, int8 codes within one at <= 0.1% of entries.
    Returns the tolerance for the outputs computed from it: TOL, or
    FLIP_TOL where an int8 code parted."""
    assert set(got) == set(exp)
    flips = 0
    for k, e in exp.items():
        g, e = got[k].numpy(), np.asarray(e)
        assert g.dtype == e.dtype, k
        if g.dtype == np.int8:
            d = np.abs(g.astype(np.int32) - e.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (k, d.sum())
            flips += int(d.sum())
        else:
            np.testing.assert_allclose(g, e, **TOL, err_msg=k)
    return FLIP_TOL if flips else TOL


def ref_cache(rcfg, batch: int, s_max: int) -> dict:
    return ref_model.init_zeros(ref_model.cache_specs(rcfg, batch, s_max))


def port_cache(exp: dict) -> dict:
    """The reference's cache as the port's (an identical input)."""
    return {k: _t(v) for k, v in exp.items()}


def _layer_input(pcfg, seed=3, s=S):
    return np.random.default_rng(seed).normal(
        size=(B, s, pcfg.d_model)).astype(np.float32)


def test_maybe_is_a_python_branch():
    assert tr._maybe(True, lambda o: o + 1, 1) == 2
    assert tr._maybe(np.bool_(False), lambda o: o + 1, 1) == 1


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_layer_flags_and_cache_specs(name):
    cfg, rcfg = get_config(name), ref_config(name)
    for a, b in ((cfg, rcfg), (cfg.reduced(), rcfg.reduced())):
        exp = ref_tr.layer_flags(b)
        got = tr.layer_flags(a)
        assert got.keys() == exp.keys()
        for k in exp:
            np.testing.assert_array_equal(got[k], exp[k])
        specs = M.cache_specs(a, 3, 40)
        assert specs == {k: (s.shape, s.dtype) for k, s in
                         ref_model.cache_specs(b, 3, 40).items()}
    assert bool(tr.layer_flags(cfg)["sliding"][0]) == (name == "gemma2-9b")


# ---------------------------------------------------------- the stack
def check_stack_forward(name):
    """``stack_forward`` with a cache to fill: hidden states, aux, cache."""
    rcfg, pcfg, params, model = case(name)
    x = _layer_input(pcfg, 9)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    rc = ref_cache(rcfg, B, S + 8)
    ex, eaux, ecache = ref_tr.stack_forward(rcfg, params["layers"],
                                            jnp.asarray(x), jnp.asarray(pos),
                                            cache=rc)
    cache = M.init_zeros(M.cache_specs(pcfg, B, S + 8), "cpu")
    gx, gaux, gcache = tr.stack_forward(pcfg, model.layers, _t(x), _t(pos),
                                        cache=cache)
    close(gx, ex, scaled=True)
    close(gaux, eaux)
    assert gcache is cache
    same_cache(gcache, ecache)
    if pcfg.family == "dense":
        assert float(gaux) == 0.0


def check_stack_decode(name):
    """``stack_decode`` from the reference's filled cache."""
    rcfg, pcfg, params, model = case(name)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    _, _, rc = ref_tr.stack_forward(rcfg, params["layers"],
                                    jnp.asarray(_layer_input(pcfg, 9)),
                                    jnp.asarray(pos),
                                    cache=ref_cache(rcfg, B, S + 8))
    x = _layer_input(pcfg, 10, 1)
    ex, ecache, _ = ref_tr.stack_decode(rcfg, params["layers"],
                                        jnp.asarray(x), jnp.asarray(POS),
                                        cache=rc)
    gx, gcache, state = tr.stack_decode(pcfg, model.layers, _t(x),
                                        _t(POS).long(), cache=port_cache(rc))
    tol = same_cache(gcache, ecache)
    close(gx, ex, scaled=True, **tol)
    assert state == {}


def check_forward(name):
    rcfg, pcfg, params, model = case(name)
    toks = tokens(pcfg)
    ex, eaux, _ = ref_model.forward(rcfg, params,
                                    {"tokens": jnp.asarray(toks)})
    gx, gaux, gcache = M.forward(pcfg, model, {"tokens": toks}, device="cpu")
    close(gx, ex)
    close(gaux, eaux)
    assert gcache is None


def check_prefill_and_decode(name):
    """``prefill`` of S tokens into an (S+8)-deep cache, then two
    ``decode_step``s, each from the reference's cache, through the step
    functions of ``launch/steps.py``."""
    rcfg, pcfg, params, model = case(name)
    toks = tokens(pcfg)
    elog, ecache = ref_model.prefill(rcfg, params,
                                     {"tokens": jnp.asarray(toks)},
                                     ref_cache(rcfg, B, S + 8))
    prefill = steps.make_prefill_step(pcfg, device="cpu")
    glog, gcache = prefill(model, {"tokens": toks},
                           M.init_zeros(M.cache_specs(pcfg, B, S + 8), "cpu"))
    close(glog, elog)
    same_cache(gcache, ecache)
    decode = steps.make_decode_step(pcfg, device="cpu")
    tok = np.asarray(jnp.argmax(elog, -1)).astype(np.int32)[:, None]
    pos = POS
    for _ in range(2):
        elog, enxt, ecache, _ = ref_model.decode_step(
            rcfg, params, jnp.asarray(tok), jnp.asarray(pos), ecache, None)
        glog, gnxt, gcache, state = decode(model, tok, pos,
                                           port_cache(ecache), {})
        close(glog, elog, **same_cache(gcache, ecache))
        np.testing.assert_array_equal(gnxt.numpy(), np.asarray(enxt))
        assert gnxt.dtype == torch.int32 and state == {}
        tok, pos = np.array(enxt)[:, None], pos + 1


@pytest.mark.parametrize("name", DENSE)
def test_stack_forward_fills_the_cache(name):
    check_stack_forward(name)


@pytest.mark.parametrize("name", DENSE)
def test_stack_decode(name):
    check_stack_decode(name)


@pytest.mark.parametrize("name", DENSE)
def test_forward(name):
    check_forward(name)


@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_steps(name):
    check_prefill_and_decode(name)


def test_bfloat16_prefill_and_decode():
    """gemma2-9b's reduced form as configured: bfloat16 compute, float32
    parameters, int8 cache.  The two packages round bfloat16 at other
    points inside fused ops, so logits within 0.1 and equal greedy
    tokens."""
    rcfg = ref_config("gemma2-9b").reduced()
    pcfg = get_config("gemma2-9b").reduced()
    params = jax.device_get(ref_model.init_params(rcfg, jax.random.PRNGKey(0)))
    model = M.params_from_numpy(pcfg, params, "cpu")
    toks = tokens(pcfg, 11)
    elog, ecache = ref_model.prefill(rcfg, params,
                                     {"tokens": jnp.asarray(toks)},
                                     ref_cache(rcfg, B, S + 8))
    glog, _ = M.prefill(pcfg, model, {"tokens": toks},
                        M.init_zeros(M.cache_specs(pcfg, B, S + 8), "cpu"),
                        device="cpu")
    close(glog, elog, atol=0.1, rtol=0)
    tok = np.asarray(jnp.argmax(elog, -1)).astype(np.int32)[:, None]
    elog, enxt, _, _ = ref_model.decode_step(rcfg, params, jnp.asarray(tok),
                                             jnp.asarray(POS), ecache, None)
    glog, gnxt, _, _ = M.decode_step(pcfg, model, tok, POS,
                                     port_cache(ecache), None, device="cpu")
    close(glog, elog, atol=0.1, rtol=0)
    np.testing.assert_array_equal(gnxt.numpy(), np.asarray(enxt))


# ---------------------------------------------- devices and paged == contiguous
def test_steps_run_on_the_card_unless_told_otherwise():
    _, pcfg, _, model = case("qwen3-4b")
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_gpu.py runs there")
    for make in (steps.make_prefill_step, steps.make_decode_step):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(pcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_zeros(M.cache_specs(pcfg, 1, 4))
    cache = M.init_zeros(M.cache_specs(pcfg, 1, 4), "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.decode_step(pcfg, model, [[1]], [0], cache, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.prefill(pcfg, model, {"tokens": [[1, 2]]}, cache)
    with pytest.raises(ValueError, match="lives on"):
        M.decode_step(pcfg, model, [[1]], [0], cache, None, device="meta")


def test_paged_decode_equals_contiguous():
    """The port's own paged decode (K6 over a shuffled page table) ==
    its contiguous ``decode_step``, in the layout and tolerance of the
    reference's ``tests/test_serving.py::TestPagedDecode``: the tiny
    qwen3-4b config (bfloat16 cache), 2 rows of 32 steps, pages of 8,
    logits within 0.15 and >= 90% equal greedy tokens."""
    cfg = dataclasses.replace(
        get_config("qwen3-4b").reduced(), n_layers=2, d_model=64, n_heads=2,
        n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=128, remat=False,
        compute_dtype="float32", param_dtype="float32")
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    n, page = 32, 8
    toks = tokens(cfg, 1, (B, n))
    cache = M.init_zeros(M.cache_specs(cfg, B, n), "cpu")
    NP = n // page
    pool = init_page_pool(cfg, B * NP + 3, page, "cpu")
    perm = np.random.default_rng(3).permutation(B * NP) + 1
    tables = torch.from_numpy((perm.reshape(B, NP) - 1).astype(np.int32))
    agree = []
    for t in range(n):
        pos = np.full((B,), t, np.int64)
        dense, _, cache, _ = M.decode_step(cfg, model, toks[:, t:t + 1], pos,
                                           cache, None, device="cpu")
        paged, _ = paged_decode_step(cfg, model, toks[:, t:t + 1], pos, pool,
                                     tables, page)
        np.testing.assert_allclose(paged.numpy(), dense.numpy(), atol=0.15)
        agree.append((paged.argmax(-1) == dense.argmax(-1)).float().mean())
    assert float(np.mean(agree)) >= 0.9
