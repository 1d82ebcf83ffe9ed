"""Qwen2-VL-72B backbone [arXiv:2409.12191].

VLM BACKBONE only: 80L, d_model=8192, 64 heads (GQA kv=8) head_dim=128,
d_ff=29568, vocab=152064, M-RoPE (temporal/height/width sections).  The
vision frontend is a STUB: the data pipeline's vision batch holds
precomputed patch embeddings and 3D (t,h,w) position ids.
"""

from repro_torch.configs.base import ModelConfig, register


@register("qwen2-vl-72b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        activation="swiglu",
        pos_type="mrope",
        rope_theta=1_000_000.0,
        frontend="vision",
        max_seq_len=32768,
        source="arXiv:2409.12191",
    )
