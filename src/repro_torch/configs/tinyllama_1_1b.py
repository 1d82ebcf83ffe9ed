"""TinyLlama-1.1B [arXiv:2401.02385] — llama2-architecture small model.

22L, d_model=2048, 32 heads (GQA kv=4), head_dim=64, d_ff=5632, vocab=32000.
"""

from repro_torch.configs.base import ModelConfig, register


@register("tinyllama-1.1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b",
        family="dense",
        n_layers=22,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=64,
        d_ff=5632,
        vocab_size=32000,
        activation="swiglu",
        pos_type="rope",
        rope_theta=10000.0,
        max_seq_len=4096,
        source="arXiv:2401.02385",
    )
