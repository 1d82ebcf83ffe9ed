"""RWKV-6 (Finch) 3B [arXiv:2404.05892].

Attention-free: 32L, d_model=2560, d_ff=8960, vocab=65536, data-dependent
decay WKV6 recurrence with head size 64 (40 WKV heads), untied
unembedding.
"""

from repro_torch.configs.base import ModelConfig, register


@register("rwkv6-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=0,  # attention-free
        n_kv_heads=0,
        d_ff=8960,
        vocab_size=65536,
        activation="relu_sq",  # RWKV channel-mix uses squared relu
        block_pattern=("rwkv",),
        rnn_head_dim=64,
        pos_type="none",
        max_seq_len=524288,
        source="arXiv:2404.05892",
    )
