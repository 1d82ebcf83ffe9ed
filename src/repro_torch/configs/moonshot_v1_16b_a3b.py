"""Moonlight-16B-A3B (moonshot-v1-16b-a3b) [hf:moonshotai/Moonlight-16B-A3B].

MoE: 48L, d_model=2048, 16 heads MHA (kv=16), per-expert d_ff=1408,
64 experts top-6, vocab=163840.
"""

from repro_torch.configs.base import ModelConfig, register


@register("moonshot-v1-16b-a3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=163840,
        activation="swiglu",
        n_experts=64,
        experts_per_token=6,
        pos_type="rope",
        rope_theta=50000.0,
        max_seq_len=8192,
        source="hf:moonshotai/Moonlight-16B-A3B",
    )
