"""The ssm, hybrid, audio and vlm families of the port == the JAX reference
on the CPU: ``forward``, ``prefill`` (the vlm's cross k/v included) and
``decode_step`` (the recurrent state included) for the reduced forms of
rwkv6-1.6b, zamba2-1.2b, musicgen-medium and llama-3.2-vision-11b, on the
reference's ``init_params`` weights; the parameter carry-over with
``extras``; the specs of all ten configs at full width; and the step
functions' ``{}`` (the decode-all-positions consistency and the serving
gate: ``test_torch_family_decode.py``).

float32 (``compute_dtype="float32"``, a float32 KV cache): logits, caches
and float32 states within 1e-4 (abs and rel), each decode step from the
reference's cache and state (a bfloat16 shift or conv row one ulp apart
moves the next step by up to 1e-2), the bfloat16 shift and conv rows
equal or one ulp apart.  Two places part further, each found op by op
(tests/test_torch_recurrent.py holds the blocks alone):

- zamba2: ``mamba_block`` multiplies by exp(cum_t - cum_s), a difference
  of two float32 cumulative sums that the libraries sum in other orders;
  a block alone parts by 1e-5 and 12 layers carry it to 3.8e-4 in the
  forward's hidden states (``DEEP_SSD_TOL``, atol 2e-3).
- rwkv6 decode: a head whose bonus term sum_d r u k nearly cancels (zero
  state, so out = (sum_d r u k) v) has mean(out^2) below ``ln_x``'s eps
  of 1e-6, and the group norm multiplies its 1e-7 absolute differences by
  up to 1/sqrt(eps) = 1000: 2.8e-4 in the logits for token 8 of the
  reduced config (``LNX_TOL``, atol 2e-3).

bfloat16 (the configs' own compute dtype): the two packages round
bfloat16 at other points (XLA keeps float32 inside its fusions, PyTorch
rounds each op's output), and each lies about as far from the float32
result as from the other: at the prefill, 6.0% (port) and 7.8%
(reference) RMS for rwkv6, 27% and 24% for zamba2, 2.1% and 2.2% for
musicgen, 1.5% and 1.5% for the vlm, largest errors 0.05-0.98.  A mamba
block or a time-mix alone parts from its float32 result by 1% RMS on either
side.  So logits within 3e-2 of the reference's bfloat16 run (the parts
are up to 0.35) would hold neither package to the other; the test holds
the port's error against the float32 result to the reference's own.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.models import model as ref_model

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.models.common import bf16_near, dtype_of

NEW = ["rwkv6-1.6b", "zamba2-1.2b", "musicgen-medium", "llama-3.2-vision-11b"]
TOL = dict(atol=1e-4, rtol=1e-4)
DEEP_SSD_TOL = dict(atol=2e-3, rtol=1e-4)
LNX_TOL = dict(atol=2e-3, rtol=1e-4)
B, S = 2, 64            # rwkv: 2 chunks of 32; mamba: one chunk of 64

_forward = jax.jit(ref_model.forward, static_argnums=0)
_prefill = jax.jit(ref_model.prefill, static_argnums=0)
_decode = jax.jit(ref_model.decode_step, static_argnums=0)


def _float32(cfg):
    kw = dict(compute_dtype="float32", remat=False)
    if cfg.kv_cache_dtype != "int8":
        kw["kv_cache_dtype"] = "float32"
    return dataclasses.replace(cfg, **kw)


def _cfgs(name: str, f32: bool):
    r, p = ref_config(name).reduced(), get_config(name).reduced()
    return (_float32(r), _float32(p)) if f32 else (r, p)


@functools.lru_cache(maxsize=None)
def _weights(name: str, f32: bool):
    """The reference's params (jnp) for the reduced ``name`` and the port's
    model holding them."""
    rcfg, pcfg = _cfgs(name, f32)
    params = jax.device_get(ref_model.init_params(rcfg,
                                                  jax.random.PRNGKey(0)))
    return (jax.tree.map(jnp.asarray, params),
            M.params_from_numpy(pcfg, params, "cpu"))


def _batch(cfg, seed=1, s=S) -> dict:
    """Tokens (frames for the audio stub) and, for the vlm, patches; the
    embeddings in the compute dtype, as numpy float32."""
    rng = np.random.default_rng(seed)
    cdt = cfg.compute_dtype
    out = {}
    if cfg.family == "audio":
        out["frames"] = np.asarray(jnp.asarray(rng.normal(
            size=(B, s, cfg.d_model)) * 0.1).astype(cdt), np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, s)).astype(
            np.int32)
    if cfg.cross_attn_period:
        out["patches"] = np.asarray(jnp.asarray(rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)) * 0.1).astype(cdt),
            np.float32)
    return out


def _jbatch(batch: dict, cfg) -> dict:
    return {k: jnp.asarray(v) if k == "tokens"
            else jnp.asarray(v).astype(cfg.compute_dtype)
            for k, v in batch.items()}


def _port(tree: dict) -> dict:
    """A reference cache or state as the port's (an identical input)."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(
        dtype_of(str(v.dtype))) for k, v in tree.items()}


def _np(t) -> np.ndarray:
    return np.asarray(t, np.float32)


def close(got: torch.Tensor, exp, **tol) -> None:
    np.testing.assert_allclose(got.float().numpy(), _np(exp), **(tol or TOL))


def cosine_min(a: torch.Tensor, b) -> float:
    a, b = a.double().numpy(), np.asarray(b, np.float64)
    return float((np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                       * np.linalg.norm(b, axis=-1))).min())


def same_rows(got: dict, exp: dict, tol: dict) -> None:
    """A cache or state: float entries within ``tol``; bfloat16 entries as
    ``bf16_near`` holds them, with ``tol``'s absolute part."""
    assert got.keys() == exp.keys()
    for k, e in exp.items():
        g = got[k]
        assert str(g.dtype).split(".")[-1] == str(e.dtype), k
        if g.dtype == torch.bfloat16:
            assert bf16_near(g, _port({k: e})[k], tol["atol"]), k
        else:
            close(g, e, **tol)


def _tol(name: str) -> dict:
    return DEEP_SSD_TOL if name == "zamba2-1.2b" else TOL


# ------------------------------------------------------------- float32
@pytest.mark.parametrize("name", NEW)
def test_forward(name):
    rcfg, pcfg = _cfgs(name, True)
    params, model = _weights(name, True)
    batch = _batch(pcfg)
    ex, eaux, _ = _forward(rcfg, params, _jbatch(batch, rcfg))
    gx, gaux, gcache = M.forward(pcfg, model, batch, device="cpu")
    close(gx, ex, **_tol(name))
    assert float(gaux) == float(eaux) == 0.0 and gcache is None


@pytest.mark.parametrize("name", NEW)
def test_prefill_and_decode_steps(name):
    """``prefill`` of S positions into an (S+8)-deep cache, then 3
    ``decode_step``s through the step functions, each from the reference's
    cache and state: logits, caches and states."""
    rcfg, pcfg = _cfgs(name, True)
    params, model = _weights(name, True)
    batch = _batch(pcfg)
    rcache = ref_model.init_zeros(ref_model.cache_specs(rcfg, B, S + 8))
    elog, ecache = _prefill(rcfg, params, _jbatch(batch, rcfg), rcache)
    cache = M.init_zeros(M.cache_specs(pcfg, B, S + 8), "cpu")
    glog, gcache = steps.make_prefill_step(pcfg, "cpu")(model, batch, cache)
    assert gcache is cache
    close(glog, elog, **_tol(name))
    same_rows(gcache, ecache, _tol(name))
    if pcfg.family in ("ssm", "hybrid"):
        # the reference's prefill does not seed the recurrent state
        estate = ref_model.init_zeros(ref_model.state_specs(rcfg, B))
    else:
        estate = {}
    decode = steps.make_decode_step(pcfg, "cpu")
    tok = np.asarray(jnp.argmax(elog, -1)).astype(np.int32)[:, None]
    pos = np.array([S, S + 3], np.int32)
    for t in range(3):
        gstate = _port(estate)
        elog, enxt, ecache, estate = _decode(
            rcfg, params, jnp.asarray(tok), jnp.asarray(pos),
            ecache or None, estate or None)
        ecache, estate = ecache or {}, estate or {}
        glog, gnxt, gcache, gstate = decode(model, tok, pos, _port(ecache),
                                            gstate)
        tol = LNX_TOL if pcfg.family == "ssm" else _tol(name)
        close(glog, elog, **tol)
        same_rows(gcache, ecache, _tol(name))
        same_rows(gstate, estate, tol)
        np.testing.assert_array_equal(gnxt.numpy(), np.asarray(enxt))
        tok, pos = np.array(enxt)[:, None], pos + 1


# ------------------------------------------------------------- bfloat16
def _rms(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.sqrt(((a - b) ** 2).mean() / (b ** 2).mean()))


@pytest.mark.parametrize("name", NEW)
def test_bfloat16_prefill_and_decode(name):
    """The reduced config as configured (bfloat16 compute, float32
    parameters, bfloat16 cache and shift/conv states): the prefill's and 2
    decode steps' logits, each package from its own bfloat16 cache and
    state, held to the reference's float32 run on the same weights and
    inputs (the truth): the port's error at most 1.25x the reference's
    bfloat16 error (RMS) and 1.5x its largest; the port == the reference
    within cosine > 0.95, tests/test_models.py's bound for bfloat16 drift
    (zamba2's second free-running decode step: 0.977)."""
    rcfg, pcfg = _cfgs(name, False)
    r32, _ = _cfgs(name, True)
    params, model = _weights(name, False)
    batch = _batch(pcfg, 2)
    jb = _jbatch(batch, rcfg)
    truth, tcache = _prefill(r32, params, {
        k: v if k == "tokens" else v.astype(jnp.float32)
        for k, v in jb.items()}, ref_model.init_zeros(
            ref_model.cache_specs(r32, B, S + 8)))
    elog, ecache = _prefill(rcfg, params, jb, ref_model.init_zeros(
        ref_model.cache_specs(rcfg, B, S + 8)))
    glog, gcache = M.prefill(pcfg, model, batch, M.init_zeros(
        M.cache_specs(pcfg, B, S + 8), "cpu"), device="cpu")
    tstate = ref_model.init_zeros(ref_model.state_specs(r32, B))
    estate = ref_model.init_zeros(ref_model.state_specs(rcfg, B))
    gstate = _port(estate)
    tok = np.asarray(jnp.argmax(truth, -1)).astype(np.int32)[:, None]
    pos = np.array([S, S + 3], np.int32)
    for t in range(3):
        assert _rms(glog, truth) <= 1.25 * _rms(elog, truth) + 1e-3, t
        assert np.abs(_np(glog) - _np(truth)).max() <= 1.5 * np.abs(
            _np(elog) - _np(truth)).max() + 1e-2, t
        assert cosine_min(glog, elog) > 0.95, t
        if t == 2:
            break
        args = (jnp.asarray(tok), jnp.asarray(pos))
        truth, _, tcache, tstate = _decode(r32, params, *args,
                                           tcache or None, tstate or None)
        elog, _, ecache, estate = _decode(rcfg, params, *args,
                                          ecache or None, estate or None)
        glog, _, gcache, gstate = M.decode_step(
            pcfg, model, tok, pos, gcache or None, gstate or None,
            device="cpu")
        tok = np.asarray(jnp.argmax(truth, -1)).astype(np.int32)[:, None]
        pos = pos + 1


# ------------------------------------------------ parameters and specs
@pytest.mark.parametrize("name", NEW)
def test_params_round_trip(name):
    """``params_from_numpy`` then ``numpy_from_params`` gives back the
    reference's tree, ``extras`` included, key for key and bit for bit;
    the port's names follow the reference's keys."""
    params, model = _weights(name, True)
    ref = jax.device_get(params)
    back = M.numpy_from_params(model)
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_p = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat_r] == \
        [jax.tree_util.keystr(k) for k, _ in flat_p]
    for (_, a), (_, b) in zip(flat_r, flat_p):
        np.testing.assert_array_equal(a, b)
    own = dict(model.named_parameters())
    cfg = get_config(name)
    if cfg.family == "ssm":
        assert torch.equal(own["layers.2.tm.wr"],
                           torch.from_numpy(ref["layers"]["tm"]["wr"][2]))
    if cfg.family == "hybrid":
        assert torch.equal(own["extras.shared_attn.attn.wq"], torch.from_numpy(
            ref["extras"]["shared_attn"]["attn"]["wq"]))
        assert torch.equal(own["layers.1.ssm.A_log"], torch.from_numpy(
            ref["layers"]["ssm"]["A_log"][1]))
    if cfg.family == "vlm":
        assert torch.equal(own["extras.cross.1.attn.wk"], torch.from_numpy(
            ref["extras"]["cross"]["attn"]["wk"][1]))
        assert torch.equal(own["extras.cross.0.ln"], torch.from_numpy(
            ref["extras"]["cross"]["ln"][0]))


def _stacked(path) -> int:
    """1 for a leaf stacked over layers or cross layers, else 0."""
    keys = [getattr(p, "key", None) for p in path]
    return int(keys[0] == "layers" or keys[:2] == ["extras", "cross"])


@pytest.mark.parametrize("name", NEW)
def test_init_params_follow_the_reference_rules(name):
    """The port's ``init_params`` applies the reference's ``_init_leaf``
    rules to the reference's (stacked) shapes: the constants equal the
    reference's values, the random leaves have its scale."""
    cfg = get_config(name).reduced()
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = jax.device_get(ref_model.init_params(ref_config(name).reduced(),
                                               jax.random.PRNGKey(0)))
    flat = {jax.tree_util.keystr(k): a for k, a in
            jax.tree_util.tree_flatten_with_path(ref)[0]}
    const = 0
    for k, a in jax.tree_util.tree_flatten_with_path(
            M.numpy_from_params(model))[0]:
        e = flat[jax.tree_util.keystr(k)]
        assert a.shape == e.shape
        if np.all(e == e.reshape(-1)[0]):        # a constant leaf
            np.testing.assert_array_equal(a, e)
            const += 1
        elif a.ndim - _stacked(k) >= 2:          # a layer's matrix
            std = float(a.std()) * np.sqrt(a.shape[-2])
            assert 0.8 < std < 1.2, jax.tree_util.keystr(k)
        else:              # a layer's vector stacked (L, n): fan-in L
            std = float(a.std()) * np.sqrt(a.shape[0])
            # within four standard errors of the sample std of n normals
            assert abs(std - 1) < 4 / np.sqrt(2 * a.size), (
                jax.tree_util.keystr(k))
    assert const >= {"ssm": 8, "hybrid": 1, "audio": 1, "vlm": 1}[cfg.family]


def _n_params(specs: dict) -> int:
    return sum(int(np.prod(s)) for s in jax.tree.leaves(
        specs, is_leaf=lambda s: isinstance(s, tuple)))


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_full_width_specs_equal_the_references(name):
    """``param_specs``, ``cache_specs`` and ``state_specs`` of every config
    at full width == the reference's, nothing allocated."""
    cfg, rcfg = get_config(name), ref_config(name)
    ref = jax.tree.map(lambda s: s.shape, ref_model.param_specs(rcfg),
                       is_leaf=lambda s: isinstance(s, ref_model.Spec))
    assert M.param_specs(cfg) == ref
    for batch, depth in ((3, 40), (128, 32_768)):
        assert M.cache_specs(cfg, batch, depth) == {
            k: (s.shape, s.dtype)
            for k, s in ref_model.cache_specs(rcfg, batch, depth).items()}
        assert M.state_specs(cfg, batch) == {
            k: (s.shape, s.dtype)
            for k, s in ref_model.state_specs(rcfg, batch).items()}


def test_registry_holds_the_ten_configs():
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    for name in ARCHS:
        model = M.DenseLM(get_config(name), "meta")
        assert sum(p.numel() for p in model.parameters()) == _n_params(
            M.param_specs(get_config(name)))


def test_unknown_family_is_refused():
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(),
                              family="diffusion")
    with pytest.raises(ValueError, match="families"):
        M.DenseLM(cfg, "cpu")


@pytest.mark.parametrize("name", NEW)
def test_decode_step_returns_empty_for_what_a_family_lacks(name):
    """As the reference's step: the cache is passed only where
    ``cache_specs`` is non-empty, the state only where ``state_specs`` is,
    and ``{}`` comes back in the place of either that the family lacks."""
    _, pcfg = _cfgs(name, True)
    _, model = _weights(name, True)
    cache = M.init_zeros(M.cache_specs(pcfg, B, 8), "cpu")
    state = M.init_zeros(M.state_specs(pcfg, B), "cpu")
    decode = steps.make_decode_step(pcfg, "cpu")
    sentinel = {"unused": torch.zeros(1)}
    _, _, c, s = decode(model, np.ones((B, 1), np.int32), np.zeros(B),
                        cache or sentinel, state or sentinel)
    assert (c is cache) if cache else c == {}
    assert (s is state) if state else s == {}
    assert bool(cache) == (pcfg.family != "ssm")
    assert bool(state) == (pcfg.family in ("ssm", "hybrid"))
