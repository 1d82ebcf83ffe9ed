"""Unified model configuration + registry for the assigned architectures.

Every architecture in the assignment is expressible as a ``ModelConfig``;
``src/repro_torch/configs/<arch>.py`` files instantiate exact published configs and
register them.  ``reduced()`` derives the CPU-smoke-test variant.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Config dataclass
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int  # 0 for attention-free layers
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // n_heads
    activation: str = "swiglu"  # swiglu | geglu | gelu
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    # ``d_ff`` is the per-expert hidden size when n_experts > 0.
    # --- layer pattern (cycled over layers) ---
    block_pattern: Tuple[str, ...] = ("attn",)  # attn | local | rglru | rwkv
    window_size: int = 0  # local-attention window
    # --- positional encoding ---
    pos_type: str = "rope"  # rope | mrope | none
    rope_theta: float = 10000.0
    # --- encoder-decoder ---
    encoder_layers: int = 0  # > 0 => enc-dec; encoder uses same dims
    # --- frontends (stubs; backbone-only archs) ---
    frontend: str = "none"  # none | audio | vision
    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # RWKV / RG-LRU
    rnn_head_dim: int = 64  # RWKV6 WKV head size
    lru_width: int = 0  # RG-LRU state width (default d_model)
    # attention-free archs set n_heads=0; enc-dec cross-attn uses n_heads.
    max_seq_len: int = 131072
    # MoE options
    moe_shared_experts: int = 0
    # source provenance (doc only)
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        if self.n_heads == 0:
            return 0
        return self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attn_free(self) -> bool:
        return all(b == "rwkv" for b in self.block_pattern)

    @property
    def subquadratic(self) -> bool:
        """True if decode memory does not grow with full context (SSM/hybrid
        with bounded local windows)."""
        return all(b in ("rwkv", "rglru", "local") for b in self.block_pattern)

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    # ------------------------------------------------------------------
    def uniform_pattern(self) -> bool:
        """All layers identical => scan-over-layers eligible."""
        return len(set(self.block_pattern)) == 1

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Approximate parameter count N (used for 6·N·D MODEL_FLOPS)."""
        d = self.d_model
        hd = self.resolved_head_dim
        counts = {"attn": 0, "local": 0, "rglru": 0, "rwkv": 0}
        for i in range(self.n_layers):
            counts[self.block_kind(i)] += 1
        n_attn = counts["attn"] + counts["local"]
        n_glu = 3 if self.activation in ("swiglu", "geglu") else 2
        # attention blocks
        attn_params = (
            d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
            + (self.n_heads * hd) * d
        )
        total = n_attn * attn_params
        # rglru blocks: in/gate proj + out proj + diagonal gates
        lru_w = self.lru_width or d
        total += counts["rglru"] * (2 * d * lru_w + lru_w * d + 4 * lru_w)
        # rwkv time-mix: r,k,v,g,o projections + decay LoRA;
        # channel-mix replaces the FFN on rwkv layers
        total += counts["rwkv"] * (5 * d * d + 2 * d * 64)
        total += counts["rwkv"] * (2 * d * self.d_ff + d * d)
        # FFN on all non-rwkv layers
        n_ffn = self.n_layers - counts["rwkv"]
        if self.is_moe:
            ffn = (self.n_experts + self.moe_shared_experts) * n_glu * d * self.d_ff
            ffn += d * self.n_experts  # router
        else:
            ffn = n_glu * d * self.d_ff
        total += n_ffn * ffn
        if self.is_encdec:
            # encoder layers: self-attn + ffn; decoder additionally cross-attn
            enc = self.encoder_layers * (attn_params + n_glu * d * self.d_ff)
            total += enc + self.n_layers * attn_params  # cross attention
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed + shared experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        n_glu = 3 if self.activation in ("swiglu", "geglu") else 2
        all_moe = (self.n_experts + self.moe_shared_experts) * n_glu * d * self.d_ff
        active_moe = (self.experts_per_token + self.moe_shared_experts) * n_glu * d * self.d_ff
        return int(self.param_count() - self.n_layers * (all_moe - active_moe))

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """CPU-smoke-scale variant of the same family."""
        period = len(self.block_pattern)
        # hybrid patterns keep >= 2 full periods so the period-scan path is
        # exercised at smoke scale
        n_layers = max(2 * period if period > 1 else 2, 2)
        # keep the pattern intact, shrink everything else
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers if not self.is_encdec else 2,
            encoder_layers=2 if self.is_encdec else 0,
            d_model=64,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, min(self.n_heads, 4)) if self.n_heads else 0,
            head_dim=16 if self.n_heads else None,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 8),
            experts_per_token=min(self.experts_per_token, 2),
            window_size=min(self.window_size, 8) if self.window_size else 0,
            lru_width=64 if self.lru_width else 0,
            rnn_head_dim=16,
            max_seq_len=128,
            dtype="float32",
        )


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers arch module imports)

    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs():
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)
