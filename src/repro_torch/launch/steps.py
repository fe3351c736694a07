"""Step functions (prefill / decode) — port of
``src/repro/launch/steps.py:65-85``.

These are the units a launcher executes: ``make_prefill_step(cfg)`` and
``make_decode_step(cfg)`` return functions with the reference's signatures
over :mod:`repro_torch.models.model`.  The device is fixed when the step is
made: ``cuda:0`` unless ``device`` names another (``"cpu"`` for the plain
path); without CUDA the default raises.  The caches are updated in place.
The reference's sharding trees (``shardings_for``, ``replicated``) have no
counterpart on one device; the train step comes with training (ROADMAP
Queue 1 item 9.6).

    step = make_decode_step(cfg)                  # on cuda:0
    logits, nxt, cache, state = step(model, tokens, pos, cache, {})
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from ..device import resolve
from ..models import model as M


def make_prefill_step(cfg: ModelConfig, device=None):
    dev = resolve(device)

    def prefill_step(params, batch, cache):
        return M.prefill(cfg, params, batch, cache, device=dev)

    return prefill_step


def make_decode_step(cfg: ModelConfig, device=None):
    dev = resolve(device)

    def decode_one(params, tokens, pos, cache, state):
        logits, nxt, cache, state = M.decode_step(
            cfg, params, tokens, pos, cache, state or None, device=dev)
        return logits, nxt, cache, state

    return decode_one
