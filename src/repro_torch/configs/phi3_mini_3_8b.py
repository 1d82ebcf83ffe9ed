"""Phi-3-mini-3.8B [arXiv:2404.14219].

Dense decoder-only: 32L, d_model=3072, 32 heads (kv=32, i.e. MHA), d_ff=8192,
vocab=32064, RoPE + SwiGLU.
"""

from repro_torch.configs.base import ModelConfig, register


@register("phi3-mini-3.8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        activation="swiglu",
        pos_type="rope",
        rope_theta=10000.0,
        max_seq_len=4096,
        source="arXiv:2404.14219",
    )
