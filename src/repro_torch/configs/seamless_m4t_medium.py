"""SeamlessM4T-medium backbone [arXiv:2308.11596].

Encoder-decoder transformer BACKBONE only (12L enc + 12L dec, d_model=1024,
16 heads MHA, d_ff=4096, vocab=256206).  The speech/text modality frontend is
a STUB: training batches carry precomputed frame embeddings
(batch, frames, d_model) for the encoder (``data/pipeline.py``).

The original uses relative position biases; the backbone here uses RoPE on
self-attention, as the reference package's copy of this config does.
"""

from repro_torch.configs.base import ModelConfig, register


@register("seamless-m4t-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family="audio",
        n_layers=12,  # decoder layers
        encoder_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab_size=256206,
        activation="gelu",
        pos_type="rope",
        frontend="audio",
        max_seq_len=32768,
        source="arXiv:2308.11596",
    )
