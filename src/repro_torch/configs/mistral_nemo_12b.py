"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407].

Dense decoder-only LM, 128k context: 40L, d_model=5120, 32 heads (GQA kv=8),
head_dim=128, d_ff=14336, vocab=131072, SwiGLU, RoPE theta=1e6.
"""

from repro_torch.configs.base import ModelConfig, register


@register("mistral-nemo-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        activation="swiglu",
        pos_type="rope",
        rope_theta=1_000_000.0,
        max_seq_len=131072,
        source="hf:mistralai/Mistral-Nemo-Base-2407",
    )
