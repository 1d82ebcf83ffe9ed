"""Overhead-driven sharding planner: the paper's crossover reasoning
applied per layer of a transformer.

For each shardable site (the FFN, the MoE dispatch, the attention
projections, the unembedding) the planner asks the CostEngine to compare
tensor-parallel execution over the mesh's ``model`` axis against
replicated "serial" execution, picks the scan chunk, and checks the HBM
constraint (feasibility before speed).  It is analytic: a mesh shape
(``{"data": 16, "model": 16}``) is all it needs, not the devices.  Given a
``Mesh`` whose positions share devices (``shards_per_device``), the
``layer_shard`` and ``moe_dispatch`` sites and the HBM check take the
distinct devices (``Mesh.distinct_devices``), which share their peak,
bandwidth and memory between their positions; the reference has no such
mesh.
Replicate decisions emit their overrides as tuples of axis names (one
entry per dimension, ``None`` for a replicated one, a tuple for several
axes), where the reference emits ``PartitionSpec``s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.costs import CostEngine, OverheadModel, resolve_engine

Spec = Tuple[Optional[object], ...]


@dataclasses.dataclass
class SiteDecision:
    site: str
    choice: str  # "shard_model" | "replicate"
    tp_cost: float  # predicted seconds per step for the TP option
    rep_cost: float  # predicted seconds for the replicated option
    reason: str


@dataclasses.dataclass
class Plan:
    decisions: List[SiteDecision]
    overrides: Dict[str, Spec]  # path-regex -> axis names per dimension
    rnn_chunk: int
    attn_chunk: int
    fits_hbm: bool
    hbm_per_chip: float

    def summary(self) -> str:
        lines = [
            f"  {d.site:12s} -> {d.choice:12s} (tp={d.tp_cost:.2e}s "
            f"rep={d.rep_cost:.2e}s) {d.reason}"
            for d in self.decisions
        ]
        lines.append(f"  rnn_chunk={self.rnn_chunk} "
                     f"attn_chunk={self.attn_chunk} "
                     f"hbm/chip={self.hbm_per_chip/1e9:.2f}GB "
                     f"fits={self.fits_hbm}")
        if self.overrides:
            lines.append("  overrides: " + ", ".join(
                f"{pat} -> {spec}" for pat, spec in self.overrides.items()))
        return "\n".join(lines)


def _param_bytes(cfg: ModelConfig, train: bool) -> float:
    n = cfg.param_count()
    # bf16 params (+ fp32 master + 2x fp32 adam moments when training)
    return n * (2 + (4 + 8 if train else 0))


def plan_model(cfg: ModelConfig, shape: ShapeSpec,
               mesh_shape: Union[Dict[str, int], "Mesh"],
               model: Optional[OverheadModel] = None,
               engine: Optional[CostEngine] = None) -> Plan:
    eng = resolve_engine(engine, model)
    hw = eng.hw
    devices = tp_devices = None
    if not isinstance(mesh_shape, dict):  # a Mesh: read its devices
        mesh = mesh_shape
        mesh_shape = dict(mesh.shape)
        devices = mesh.distinct_devices()
        if "model" in mesh_shape:
            tp_devices = mesh.distinct_devices("model")
    chips = 1
    for v in mesh_shape.values():
        chips *= v
    tp = mesh_shape.get("model", 1)
    dp = chips // tp
    train = shape.kind == "train"
    tokens_local = shape.global_batch * (
        shape.seq_len if shape.kind != "decode" else 1) // dp
    d = cfg.d_model
    fsdp_axes = tuple(a for a in mesh_shape if a != "model")
    fsdp = fsdp_axes if len(fsdp_axes) > 1 else (
        fsdp_axes[0] if fsdp_axes else None)

    decisions: List[SiteDecision] = []
    overrides: Dict[str, Spec] = {}

    def compare(site: str, m_: int, n_: int, k_: int,
                patterns: List[Tuple[str, Spec]]) -> str:
        dec = eng.decide_layer_shard(m_, n_, k_, tp=tp, devices=tp_devices)
        rep_cost = dec.baseline.total
        tp_cost = min((a.total for a in dec.alternatives
                       if a.strategy != "serial"), default=rep_cost)
        choice = dec.choice
        reason = ("TP collective amortized by compute"
                  if choice == "shard_model" else
                  "below crossover: collective+launch overhead exceeds "
                  "compute saved")
        decisions.append(SiteDecision(site, choice, tp_cost, rep_cost, reason))
        if choice == "replicate":
            for pat, rep_spec in patterns:
                overrides[pat] = rep_spec
        return choice

    if not cfg.is_moe:
        compare("ffn", tokens_local, cfg.d_ff, d, [
            (r"ffn/(w_in|w_gate)$", (fsdp, None)),
            (r"ffn/w_out$", (None, fsdp)),
        ])
    else:
        dec = eng.decide_moe_dispatch(tokens_local, d,
                                      top_k=cfg.experts_per_token,
                                      ep_shards=tp, devices=tp_devices)
        costs = {a.strategy: a.total for a in dec.alternatives}
        decisions.append(SiteDecision(
            "moe_dispatch", dec.choice, costs["all_to_all"],
            costs["replicated_psum"], f"EP collective choice {costs}"))
    if cfg.n_heads:
        hd = cfg.resolved_head_dim
        compare("attn_qkvo", tokens_local, cfg.n_heads * hd, d, [
            (r"(attn|cross)/w[qkv]$", (fsdp, None, None)),
            (r"(attn|cross)/wo$", (None, fsdp)),
        ])
    compare("unembed", tokens_local, cfg.vocab_size, d, [
        (r"(embed|unembed)$", (None, fsdp)),
    ])

    rnn_chunk = 64
    if any(b in ("rwkv", "rglru") for b in cfg.block_pattern) and \
            shape.kind != "decode":
        heads = max(cfg.d_model // cfg.rnn_head_dim, 1)
        rnn_chunk = eng.decide_scan_chunk(
            shape.seq_len, batch=max(shape.global_batch // dp, 1),
            heads=heads, head_dim=cfg.rnn_head_dim).value
    attn_chunk = 1024 if shape.seq_len <= 65536 else 2048

    # HBM is a device's: positions on one device share it
    held = chips if devices is None else devices
    pbytes = _param_bytes(cfg, train) / held
    if shape.kind == "decode":
        hd = cfg.resolved_head_dim or 0
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if cfg.block_kind(i) == "attn")
        n_local = sum(1 for i in range(cfg.n_layers)
                      if cfg.block_kind(i) == "local")
        cache = 2 * 2 * cfg.n_kv_heads * hd * shape.global_batch * (
            n_attn * shape.seq_len + n_local * max(cfg.window_size, 1))
        pbytes += cache / held
    else:
        act = 2 * tokens_local * d * cfg.n_layers / max(tp, 1) * 2
        # a device holds the activations of each position on it
        pbytes += (act / dp if dp else act) * (chips // held)
    fits = pbytes < hw.hbm_bytes * 0.9

    return Plan(decisions=decisions, overrides=overrides, rnn_chunk=rnn_chunk,
                attn_chunk=attn_chunk, fits_hbm=fits, hbm_per_chip=pbytes)
