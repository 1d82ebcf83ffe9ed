"""Gemma-2B [arXiv:2403.08295].

18L, d_model=2048, 8 heads MQA (kv=1), head_dim=256, d_ff=16384 (GeGLU),
vocab=256000, tied embeddings.
"""

from repro_torch.configs.base import ModelConfig, register


@register("gemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        activation="geglu",
        pos_type="rope",
        rope_theta=10000.0,
        tie_embeddings=True,
        max_seq_len=8192,
        source="arXiv:2403.08295",
    )
