"""The port's recurrent blocks == the JAX reference on the CPU: rwkv6's
``time_mix``, ``channel_mix``, ``rwkv_decode`` and ``rwkv_channel_decode``,
and mamba2's ``_conv1d``, ``mamba_block`` and ``mamba_decode``, on the same
seeded numpy parameters, inputs and states, in float32; multi-chunk
sequences (3 rwkv chunks of 32, 2 mamba chunks of 256) and the chunk
asserts on both sides.

Parameters are drawn here rather than by ``init_params``, so that every
vector is exercised: mixes in [0, 1], decays whose log-decay floor binds
for some channels, nonzero bonuses, biases and norm scales.

Tolerance 1e-4 (abs and rel), with one exception.  The chunked forms
multiply by ``exp(cum_t - cum_s)``, a difference of two float32 cumulative
sums of the log decays, and the two libraries sum them in other orders
(XLA's ``reduce_window``; PyTorch's sequential sum, in double on the CPU):
the factors then differ, in relative terms, by a few ulps of |cum|.  For
rwkv |cum| <= 30 (the floor), about 1e-5 at the outputs.  In a mamba chunk
of 256 the head with A = -16 (the reference's ``A_log`` init) reaches
|cum| = 2.9e3, where a float32 ulp is 2.4e-4: 3 of 131,072 outputs then
differ by up to 1.8e-4 (2.3e-3 relative), so ``mamba_block`` at 256 and
512 positions is held within ``SSD_TOL`` (atol 5e-4).  Each decode step
starts from the reference's state (a bfloat16 conv or shift row one ulp
apart moves the next step's output by up to 2e-3) and agrees to about
1e-6; its bfloat16 shift and conv rows are equal or one bfloat16 ulp apart
(a value 1e-7 from a rounding boundary may round either way).
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.models import mamba2 as ref_mamba
from repro.models import rwkv6 as ref_rwkv

from repro_torch.configs import get_config
from repro_torch.models import mamba2, rwkv6
from repro_torch.models.common import bf16_ulps, dtype_of

TOL = dict(atol=1e-4, rtol=1e-4)
SSD_TOL = dict(atol=5e-4, rtol=1e-4)
B = 2


def _cfgs(name):
    kw = dict(compute_dtype="float32", remat=False)
    return (dataclasses.replace(ref_config(name).reduced(), **kw),
            dataclasses.replace(get_config(name).reduced(), **kw))


def _params(specs: dict, seed: int) -> dict:
    """Seeded float32 values for a ``name -> (shape, axes)`` spec dict:
    matrices normal / sqrt(fan_in); the named vectors as the module
    docstring says; other vectors normal * 0.1."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, _) in specs.items():
        if len(shape) >= 2:
            a = rng.normal(size=shape) / np.sqrt(shape[0])
        elif name.startswith(("mix", "cmix")):
            a = rng.uniform(0, 1, shape)
        elif name == "w_base":      # floor binds where exp(lw) < 0.9375
            a = rng.uniform(-3, 0.5, shape)
        elif name == "A_log":
            a = np.log(np.linspace(1.0, 16.0, shape[0]))
        elif name in ("u", "D", "dt_bias"):
            a = rng.normal(size=shape) * 0.5
        else:
            a = rng.normal(size=shape) * 0.1
        out[name] = a.astype(np.float32)
    return out


def _module(cls, pcfg, p: dict):
    m = cls(pcfg, torch.float32, "cpu")
    with torch.no_grad():
        for k, v in p.items():
            getattr(m, k).copy_(torch.from_numpy(v))
    return m


def _jnp(p: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in p.items()}


def _x(shape, seed, scale=1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _state(specs: dict, seed: int) -> dict:
    """A seeded nonzero state of the reference's (jnp arrays)."""
    rng = np.random.default_rng(seed)
    return {k: jnp.asarray((rng.normal(size=shape) * 0.5).astype(
        np.float32)).astype(dt) for k, (shape, dt) in specs.items()}


def _port_state(ref: dict) -> dict:
    """The reference's state as the port's (an identical input)."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(
        dtype_of(str(v.dtype))) for k, v in ref.items()}


def close(got: torch.Tensor, exp, **tol) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), **(tol or TOL))


def same_state(got: dict, exp: dict) -> None:
    """float32 rows within TOL; bfloat16 rows equal or one ulp apart."""
    assert got.keys() == exp.keys()
    for k, e in exp.items():
        g = got[k]
        if g.dtype == torch.bfloat16:
            assert _ulps(g, e) <= 1, k
        else:
            close(g, e)


# ------------------------------------------------------------------ rwkv6
def _rwkv(seed=0):
    rcfg, pcfg = _cfgs("rwkv6-1.6b")
    p = _params(rwkv6.rwkv_param_specs(pcfg), seed)
    return rcfg, pcfg, p, _module(rwkv6.RWKV, pcfg, p)


def test_rwkv_constants_and_specs():
    assert (rwkv6.CHUNK, rwkv6.LORA, rwkv6.CLAMP, rwkv6.LOGW_FLOOR) == (
        ref_rwkv.CHUNK, ref_rwkv.LORA, ref_rwkv.CLAMP, ref_rwkv.LOGW_FLOOR)
    for name in ("rwkv6-1.6b",):
        rcfg, pcfg = _cfgs(name)
        assert rwkv6.rwkv_param_specs(pcfg) == ref_rwkv.rwkv_param_specs(rcfg)
        assert rwkv6.rwkv_state_specs(pcfg, 3, 5) == \
            ref_rwkv.rwkv_state_specs(rcfg, 3, 5)


@pytest.mark.parametrize("S", [8, 32, 96], ids=["S8", "S32", "S96-3chunks"])
def test_time_mix(S):
    rcfg, pcfg, p, m = _rwkv()
    x = _x((B, S, pcfg.d_model), 1)
    exp = ref_rwkv.time_mix(rcfg, _jnp(p), jnp.asarray(x))
    close(rwkv6.time_mix(pcfg, m, torch.from_numpy(x)), exp)


def test_time_mix_floor_binds():
    """The inputs of test_time_mix reach the log-decay floor for some
    channels and stay above it for others."""
    rcfg, pcfg, p, m = _rwkv()
    x = torch.from_numpy(_x((B, 96, pcfg.d_model), 1))
    logw = rwkv6._time_mix_inputs(pcfg, m, x, rwkv6._shift(x))[4]
    at_floor = (logw == rwkv6.LOGW_FLOOR).float().mean()
    assert 0.01 < float(at_floor) < 0.99


def test_channel_mix():
    rcfg, pcfg, p, m = _rwkv()
    x = _x((B, 40, pcfg.d_model), 2)
    close(rwkv6.channel_mix(pcfg, m, torch.from_numpy(x)),
          ref_rwkv.channel_mix(rcfg, _jnp(p), jnp.asarray(x)))


def test_rwkv_decode_steps():
    """Three steps of ``rwkv_decode`` then ``rwkv_channel_decode`` at layer
    1 of a 3-layer state, from a seeded nonzero state: outputs and every
    state row (the other layers' rows untouched, written in place)."""
    rcfg, pcfg, p, m = _rwkv()
    rs = _state(rwkv6.rwkv_state_specs(pcfg, B, 3), 3)
    for t in range(3):
        ps = _port_state(rs)
        keep = {k: v.clone() for k, v in ps.items()}
        x = _x((B, 1, pcfg.d_model), 10 + t)
        ey, rs = ref_rwkv.rwkv_decode(rcfg, _jnp(p), jnp.asarray(x), rs, 1)
        gy, out = rwkv6.rwkv_decode(pcfg, m, torch.from_numpy(x), ps, 1)
        assert out is ps
        close(gy, ey)
        ey, rs = ref_rwkv.rwkv_channel_decode(rcfg, _jnp(p), jnp.asarray(x),
                                              rs, 1)
        gy, _ = rwkv6.rwkv_channel_decode(pcfg, m, torch.from_numpy(x), ps, 1)
        close(gy, ey)
        same_state(ps, rs)
        for k in ps:
            assert torch.equal(ps[k][0], keep[k][0]) and torch.equal(
                ps[k][2], keep[k][2])
            assert not torch.equal(ps[k][1], keep[k][1])


def test_rwkv_decode_equals_time_mix():
    """Token by token from a zero state, the recurrent step == the chunked
    form over 96 positions (3 chunks), in the port."""
    _, pcfg, _, m = _rwkv()
    x = torch.from_numpy(_x((B, 96, pcfg.d_model), 4))
    full = rwkv6.time_mix(pcfg, m, x)
    specs = rwkv6.rwkv_state_specs(pcfg, B, 1)
    state = {k: torch.zeros(s, dtype=dtype_of(d)) for k, (s, d) in
             specs.items()}
    state["tshift_t"] = state["tshift_t"].float()   # carry x unrounded
    steps = [rwkv6.rwkv_decode(pcfg, m, x[:, t:t + 1], state, 0)[0]
             for t in range(96)]
    close(torch.cat(steps, 1), full.numpy(), atol=1e-4, rtol=1e-3)


def test_rwkv_chunk_assert_on_both_sides():
    rcfg, pcfg, p, m = _rwkv()
    x = _x((1, 40, pcfg.d_model), 5)
    with pytest.raises(AssertionError):
        ref_rwkv.time_mix(rcfg, _jnp(p), jnp.asarray(x))
    with pytest.raises(ValueError, match="multiple of chunk 32"):
        rwkv6.time_mix(pcfg, m, torch.from_numpy(x))


# ----------------------------------------------------------------- mamba2
def _mamba(seed=0):
    rcfg, pcfg = _cfgs("zamba2-1.2b")
    p = _params(mamba2.mamba_param_specs(pcfg), seed)
    return rcfg, pcfg, p, _module(mamba2.Mamba2, pcfg, p)


def test_mamba_constants_and_specs():
    rcfg, pcfg = _cfgs("zamba2-1.2b")
    assert mamba2.CHUNK == ref_mamba.CHUNK
    assert mamba2.mamba_param_specs(pcfg) == ref_mamba.mamba_param_specs(rcfg)
    assert mamba2.mamba_state_specs(pcfg, 3, 5) == \
        ref_mamba.mamba_state_specs(rcfg, 3, 5)


def _ulps(g: torch.Tensor, e) -> int:
    """The most bfloat16 ulps between the port's and the reference's."""
    return int(bf16_ulps(g, torch.from_numpy(np.asarray(e, np.float32)).to(
        torch.bfloat16)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d(dtype, with_state):
    """The causal depthwise conv and its carried state.  float32 within
    1e-6.  In bfloat16 the K products are summed in bfloat16 on both
    sides and the new state (the last K-1 inputs) is equal; the output
    passes through silu, which the reference computes as x * sigmoid(x)
    rounded twice to bfloat16 and PyTorch rounds once, so it may lie 2
    ulps apart."""
    C, K = 40, 4
    x = jnp.asarray(_x((B, 9, C), 6)).astype(dtype)
    w = jnp.asarray(_x((K, C), 7, 0.5))
    st = jnp.asarray(_x((B, K - 1, C), 8)).astype(dtype) if with_state \
        else None

    def port(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype_of(dtype))

    ey, es = ref_mamba._conv1d(x, w, st)
    gy, gs = mamba2._conv1d(port(x), port(w).float(),
                            None if st is None else port(st))
    assert gy.dtype == gs.dtype == dtype_of(dtype)
    assert tuple(gs.shape) == es.shape
    if dtype == "float32":
        close(gy, ey, atol=1e-6, rtol=1e-6)
        close(gs, es, atol=0, rtol=0)
    else:
        assert _ulps(gy, ey) <= 2 and _ulps(gs, es) == 0


@pytest.mark.parametrize("S", [64, 256, 512], ids=["S64", "S256",
                                                   "S512-2chunks"])
def test_mamba_block(S):
    rcfg, pcfg, p, m = _mamba()
    x = _x((B, S, pcfg.d_model), 9)
    exp = ref_mamba.mamba_block(rcfg, _jnp(p), jnp.asarray(x))
    close(mamba2.mamba_block(pcfg, m, torch.from_numpy(x)), exp,
          **(TOL if S < 256 else SSD_TOL))


def test_mamba_decode_steps():
    """Three ``mamba_decode`` steps at layer 1 of a 3-layer state, from a
    seeded nonzero state: outputs and every state row (the others
    untouched, written in place)."""
    rcfg, pcfg, p, m = _mamba()
    rs = _state(mamba2.mamba_state_specs(pcfg, B, 3), 11)
    for t in range(3):
        ps = _port_state(rs)
        keep = {k: v.clone() for k, v in ps.items()}
        x = _x((B, 1, pcfg.d_model), 20 + t)
        ey, rs = ref_mamba.mamba_decode(rcfg, _jnp(p), jnp.asarray(x), rs, 1)
        gy, out = mamba2.mamba_decode(pcfg, m, torch.from_numpy(x), ps, 1)
        assert out is ps
        close(gy, ey)
        same_state(ps, rs)
        for k in ps:
            assert torch.equal(ps[k][0], keep[k][0]) and torch.equal(
                ps[k][2], keep[k][2])
            assert not torch.equal(ps[k][1], keep[k][1])


def test_mamba_decode_equals_block():
    """Token by token from a zero state, the recurrent step == the SSD
    chunked form over 512 positions (2 chunks), in the port (a float32
    conv state, so the carried inputs are not rounded), within SSD_TOL's
    absolute part."""
    _, pcfg, _, m = _mamba()
    x = torch.from_numpy(_x((B, 512, pcfg.d_model), 12))
    full = mamba2.mamba_block(pcfg, m, x)
    specs = mamba2.mamba_state_specs(pcfg, B, 1)
    state = {k: torch.zeros(s) for k, (s, _) in specs.items()}
    steps = [mamba2.mamba_decode(pcfg, m, x[:, t:t + 1], state, 0)[0]
             for t in range(512)]
    close(torch.cat(steps, 1), full.numpy(), atol=SSD_TOL["atol"],
          rtol=1e-3)


def test_mamba_chunk_assert_on_both_sides():
    rcfg, pcfg, p, m = _mamba()
    x = _x((1, 300, pcfg.d_model), 13)
    with pytest.raises(AssertionError, match="multiple of chunk 256"):
        ref_mamba.mamba_block(rcfg, _jnp(p), jnp.asarray(x))
    with pytest.raises(ValueError, match="multiple of chunk 256"):
        mamba2.mamba_block(pcfg, m, torch.from_numpy(x))
