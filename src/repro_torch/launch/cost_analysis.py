"""Roofline terms and model flops for the dry-run — the counterpart of
``src/repro/launch/hlo_analysis.py``.

The reference reads its terms from XLA: the per-device HLO's cost
analysis (flops, bytes accessed) and the collectives it parses from the
HLO text.  The port has no compiler to ask: ``launch.dryrun`` counts a
step's flops (``torch.utils.flop_counter``) and the bytes of every op's
operands and results on the meta device, and divides them by the mesh's
chips.  There is no HLO, so nothing here parses collectives: a
:class:`Roofline`'s collective term is ``None`` and :attr:`Roofline.
dominant` is taken over the terms that exist.  ``collective_bytes``,
``cost_props``, ``roofline_from_compiled`` and the dry-run's
``probe_costs`` have no counterpart.

The hardware constants are one NVIDIA H100 SXM's published peaks (dense
bfloat16 without sparsity, HBM3), at its full 700 W power limit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# NVIDIA H100 SXM (per card)
H100_PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense
H100_HBM_BW = 3.35e12              # B/s


@dataclasses.dataclass
class Roofline:
    """Per-device roofline terms, in seconds (``None``: not measurable
    here)."""
    compute_s: float
    memory_s: float
    collective_s: Optional[float]
    flops: float                  # per-device flops
    hbm_bytes: float              # per-device operand and result bytes
    coll_bytes: Optional[float]   # per-device collective wire bytes

    def _terms(self) -> dict:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self._terms().values())

    def row(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops_per_dev": self.flops, "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
        }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for a train step;
    2*N*D for one forward-only token batch (prefill/decode)."""
    from ..models.model import param_spec_tree
    from ..tree import leaves

    n_params = 0
    for s in leaves(param_spec_tree(cfg)):
        n = 1
        for d in s.shape:
            n *= d
        n_params += n
    n_active = n_params
    if cfg.n_experts and cfg.top_k:
        # routed expert params counted at top_k/n_experts utilization
        per_layer = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts
        routed_total = per_layer * cfg.n_layers
        n_active = n_params - routed_total * (1 - cfg.top_k / cfg.n_experts)
    tokens = shape.global_batch * (shape.seq_len if shape.kind in
                                   ("train", "prefill") else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens
