"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427].

Hybrid: 26 layers in a (RG-LRU, RG-LRU, local-attention) 1:2 pattern,
d_model=2560, 10 heads MQA (kv=1) head_dim=256 for the attention blocks,
d_ff=7680 (GeGLU), vocab=256000, local window 2048, lru_width=2560.
Sub-quadratic: runs long_500k.
"""

from repro_torch.configs.base import ModelConfig, register


@register("recurrentgemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        activation="geglu",
        block_pattern=("rglru", "rglru", "local"),
        window_size=2048,
        lru_width=2560,
        pos_type="rope",
        tie_embeddings=True,
        max_seq_len=524288,
        source="arXiv:2402.19427",
    )
