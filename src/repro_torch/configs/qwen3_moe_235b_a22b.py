"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-235B-A22B family].

MoE: 94L, d_model=4096, 64 heads (GQA kv=4) head_dim=128, per-expert
d_ff=1536, 128 experts top-8, vocab=151936.
"""

from repro_torch.configs.base import ModelConfig, register


@register("qwen3-moe-235b-a22b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        vocab_size=151936,
        activation="swiglu",
        n_experts=128,
        experts_per_token=8,
        pos_type="rope",
        rope_theta=1_000_000.0,
        max_seq_len=32768,
        source="hf:Qwen/Qwen3-30B-A3B (235B-A22B dims)",
    )
