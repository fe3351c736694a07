"""The ssm, hybrid, audio and vlm families of the port: decode against
their own forward on the CPU (the decode-all-positions consistency of
``tests/test_models.py``), and the serving gate, against the JAX
reference (the paged ``ServeEngine`` on the audio and vlm text stacks, the
launcher refusing the recurrent families), on the reduced configs and
weights of ``test_torch_families.py``.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.launch import serve as ref_serve
from repro.models import model as ref_model
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefEngine

from repro_torch.configs import get_config
from repro_torch.launch import serve, steps
from repro_torch.models import model as M
from repro_torch.models.common import dtype_of
from repro_torch.serving import Request, ServeEngine
from test_torch_families import (B, NEW, S, _batch, _cfgs, _decode, _forward,
                                 _weights, close, cosine_min)


# ---------------------------------------------------------- consistency
def _decode_all(pcfg, model, batch: dict, toks, f32_rows: bool):
    """The port's last logits after decoding: every position from a zero
    state (ssm, hybrid: their prefill does not seed it), or the last after
    a prefill of S-1 (audio, vlm).  ``f32_rows``: the shift and conv rows
    held in float32 instead of the configured bfloat16."""
    specs = M.state_specs(pcfg, B)
    if f32_rows:
        specs = {k: (shape, "float32") for k, (shape, _) in specs.items()}
    cache = M.init_zeros(M.cache_specs(pcfg, B, S), "cpu")
    state = M.init_zeros(specs, "cpu")
    decode = steps.make_decode_step(pcfg, "cpu")
    if pcfg.family in ("ssm", "hybrid"):
        for t in range(S):
            dec, _, cache, state = decode(model, toks[:, t:t + 1],
                                          np.full(B, t), cache, state)
        return dec
    pre = {k: (v[:, :S - 1] if k != "patches" else v)
           for k, v in batch.items()}
    _, cache = M.prefill(pcfg, model, pre, cache, device="cpu")
    return decode(model, toks[:, S - 1:], np.full(B, S - 1), cache,
                  state)[0]


@pytest.mark.parametrize("name", NEW)
def test_decode_consistent_with_forward(name):
    """tests/test_models.py's check on the port, in float32: the decoded
    last logits == the forward's (audio: frames equal to the tokens'
    embedding rows in the compute dtype) within 1e-3, cosine > 0.9999.
    The ssm and hybrid families decode every position from a zero state;
    so held, with the shift and conv rows in float32, the recurrences equal
    the chunked forms.  With the configured bfloat16 rows each step rounds
    the carried x (as the reference does) and the two part by up to 0.26
    (zamba2) in the logits: there cosine > 0.99."""
    _, pcfg = _cfgs(name, True)
    _, model = _weights(name, True)
    batch = _batch(pcfg, 3)
    if pcfg.family == "audio":
        toks = np.random.default_rng(4).integers(0, pcfg.vocab_size, (B, S))
        batch = {"frames": model.embed[torch.from_numpy(toks)].to(
            dtype_of(pcfg.compute_dtype))}
    else:
        toks = batch["tokens"]
    x, _, _ = M.forward(pcfg, model, batch, device="cpu")
    full = M._head(pcfg, model, x[:, -1:])[:, 0].numpy()
    dec = _decode_all(pcfg, model, batch, toks, f32_rows=True)
    close(dec, full, atol=1e-3, rtol=1e-3)
    assert cosine_min(dec, full) > 0.9999
    if pcfg.family in ("ssm", "hybrid"):
        dec = _decode_all(pcfg, model, batch, toks, f32_rows=False)
        assert cosine_min(dec, full) > 0.99


def _deep(cfg):
    """``cfg.reduced()``'s widths at the full config's depth."""
    return dataclasses.replace(cfg.reduced(), n_layers=cfg.n_layers,
                               shared_attn_period=cfg.shared_attn_period)


def _ref_last(rcfg, params, toks):
    """The reference's forward last logits and its decode of every
    position from a zero state."""
    x, _, _ = _forward(rcfg, params, {"tokens": jnp.asarray(toks)})
    full = ref_model._head(rcfg, params, x[:, -1:])[:, 0]
    cache = ref_model.init_zeros(ref_model.cache_specs(rcfg, B, S))
    state = ref_model.init_zeros(ref_model.state_specs(rcfg, B))
    for t in range(S):
        dec, _, cache, state = _decode(
            rcfg, params, jnp.asarray(toks[:, t:t + 1]),
            jnp.full((B,), t, jnp.int32), cache or None, state)
    return np.asarray(full, np.float32), np.asarray(dec, np.float32)


def _port_forward_last(pcfg, model, toks) -> torch.Tensor:
    x, _, _ = M.forward(pcfg, model, {"tokens": torch.from_numpy(toks)},
                        device="cpu")
    return M._head(pcfg, model, x[:, -1:])[:, 0]


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_deep_bfloat16_decode_parts_as_the_references(name):
    """At the full config's depth (reduced widths; 24 and 38 layers) and
    S = 64, as configured in bfloat16, every rounding grows through the
    random deep stack, in the reference as in the port.  Measured here:
    the decode-all-positions cosine against the forward is 0.9864
    (rwkv6) and 0.6617 (zamba2) for the reference, 0.9786 and 0.5945 for
    the port; against the float32 forward, the bfloat16 forward and
    decode give 0.8326 and 0.8310 (rwkv6), 0.1663 and 0.2102 (zamba2) in
    the reference, 0.8052 and 0.8319, 0.3045 and 0.3469 in the port.  Held: the port's decode parts from its forward at most
    1.5 times as far (1 - cosine, plus 0.01) as the reference's does;
    in each package the bfloat16 decode lies no farther from the float32
    forward than the bfloat16 forward does (the same ratio: the rule
    ``chip_smoke.py`` holds the full-width runs to); and the port in
    float32 with float32 rows decodes to its forward (cosine > 0.9999)."""
    ratio, slack = 1.5, 0.01
    rcfg, pcfg = _deep(ref_config(name)), _deep(get_config(name))
    params = jax.device_get(ref_model.init_params(rcfg,
                                                  jax.random.PRNGKey(0)))
    model = M.params_from_numpy(pcfg, params, "cpu")
    params = jax.tree.map(jnp.asarray, params)
    toks = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (B, S)).astype(np.int32)
    r32 = dataclasses.replace(rcfg, compute_dtype="float32",
                              kv_cache_dtype="float32")
    p32 = dataclasses.replace(pcfg, compute_dtype="float32",
                              kv_cache_dtype="float32")
    x, _, _ = _forward(r32, params, {"tokens": jnp.asarray(toks)})
    ref_full32 = ref_model._head(r32, params, x[:, -1:])[:, 0]
    ref_full, ref_dec = _ref_last(rcfg, params, toks)
    with torch.no_grad():
        full32 = _port_forward_last(p32, model, toks)
        dec32 = _decode_all(p32, model, {}, torch.from_numpy(toks), True)
        full = _port_forward_last(pcfg, model, toks)
        dec = _decode_all(pcfg, model, {}, torch.from_numpy(toks), False)

    def far(a, b) -> float:
        return 1 - cosine_min(torch.as_tensor(np.asarray(a, np.float32)), b)

    assert far(dec, full) <= ratio * far(ref_dec, ref_full) + slack
    assert far(ref_dec, ref_full32) <= ratio * far(ref_full, ref_full32) \
        + slack
    assert far(dec, full32) <= ratio * far(full, full32) + slack
    assert cosine_min(dec32, full32) > 0.9999


# ------------------------------------------------------------- serving
SERVE_TINY = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                  head_dim=32, d_ff=256, vocab_size=256, remat=False,
                  compute_dtype="float32")


@pytest.mark.parametrize("name", ["musicgen-medium", "llama-3.2-vision-11b"])
def test_serve_engine_token_stream_matches_reference(name):
    """The paged step serves the text stack of the audio and vlm families
    (the vlm's cross layers unused, as in the reference): the port's
    ``ServeEngine`` gives the reference's token streams on the serving
    demo's tiny config."""
    rcfg = dataclasses.replace(ref_config(name).reduced(), **SERVE_TINY)
    pcfg = dataclasses.replace(get_config(name).reduced(), **SERVE_TINY)
    params = ref_model.init_params(rcfg, jax.random.PRNGKey(0))
    model = M.params_from_numpy(pcfg, jax.device_get(params), "cpu")
    kw = dict(slots=2, page_size=8, n_pages=32, max_pages_per_seq=8)
    ref, port = RefEngine(rcfg, params, **kw), ServeEngine(
        pcfg, model, device="cpu", **kw)
    rng = np.random.default_rng(5)
    for i in range(3):
        prompt = rng.integers(1, pcfg.vocab_size, 3 + i).tolist()
        ref.submit(RefRequest(rid=i, prompt=list(prompt), max_new=4))
        port.submit(Request(rid=i, prompt=list(prompt), max_new=4))
    got = {r.rid: r.out for r in port.run(max_steps=100)}
    exp = {r.rid: r.out for r in ref.run(max_steps=100)}
    assert got == exp and len(got) == 3


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_serve_cli_refuses_recurrent_families(name, monkeypatch):
    """The serving launcher admits the attention families and refuses the
    ssm and hybrid ones with the reference's message."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", name])
    with pytest.raises(SystemExit) as ref:
        ref_serve.main()
    with pytest.raises(SystemExit) as port:
        serve.main(["--arch", name, "--device", "cpu"])
    assert str(port.value) == str(ref.value) == (
        "paged serving demo targets attention archs, not "
        + get_config(name).family)
