"""Deterministic synthetic data pipeline.

* **step-indexed determinism** — ``batch_at(step)`` draws every batch from
  a ``torch.Generator`` seeded by (seed, step, host); any process can
  (re)generate any step, so a restart needs no data state beyond the step.
* **host-sharded generation** — each host makes only its slice of the
  global batch.
* **structured, not uniform, tokens** — every 4th token is a Zipf unigram
  (exponent 1.1), the rest follow a periodic backbone ``(a·t + b) % V``
  with (a, b) drawn per row, so a model can learn it.

A vision (VLM) config's batch adds the stub frontend's inputs, as the
reference's does: ``vision_embeds`` (B, P, d), normal x 0.02 fp32 with P
= ``_vlm_patches(cfg, seq_len)``, and the text-only (B, S, 3) M-RoPE
``positions``.  An encoder-decoder config's batch adds the audio stub's
``frames`` (B, S, d), normal x 0.1 fp32, one frame per token position.

``make_batch_specs`` gives the dry run's inputs: meta tensors of every
model input at a shape, with the reference's keys, shapes and dtypes (the
token and position ids int32), which allocate nothing.

The mixture and its distributions are the reference's
(``src/repro/data/pipeline.py``), but not its bits: the reference draws
from ``jax.random`` (threefry), this from torch's generator, so the same
seed gives other tokens.  The parity tests feed both packages the
reference's own batches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.model import _vlm_patches, mrope_positions

ZIPF_EXPONENT = 1.1


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    device: str = "cpu"  # where batch_at puts the tokens

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.n_hosts} hosts")
        return self.global_batch // self.n_hosts

    def _generator(self, step: int) -> torch.Generator:
        words = np.random.SeedSequence(
            [self.seed, step, self.host_id]).generate_state(2)
        return torch.Generator().manual_seed(
            (int(words[0]) << 32 | int(words[1])) & ((1 << 63) - 1))

    def _tokens(self, gen: torch.Generator, batch: int) -> torch.Tensor:
        v = self.cfg.vocab_size
        ranks = torch.arange(1, v + 1, dtype=torch.float64)
        probs = ranks ** -ZIPF_EXPONENT
        uni = torch.multinomial(probs, batch * self.seq_len, replacement=True,
                                generator=gen).reshape(batch, self.seq_len)
        a = torch.randint(1, 97, (batch, 1), generator=gen)
        b = torch.randint(0, v, (batch, 1), generator=gen)
        t = torch.arange(self.seq_len)[None]
        backbone = (a * t + b) % v
        return torch.where((t % 4) == 3, uni, backbone)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """``{"tokens": (host_batch, seq_len) int64}`` for ``step``; for
        a vision config ``vision_embeds`` (host_batch, P, d) fp32 and
        ``positions`` (host_batch, seq_len, 3) int64; for an
        encoder-decoder config ``frames`` (host_batch, seq_len, d) fp32."""
        gen = self._generator(step)
        b = self.host_batch
        batch = {"tokens": self._tokens(gen, b)}
        if self.cfg.frontend == "vision":
            p = _vlm_patches(self.cfg, self.seq_len)
            batch["vision_embeds"] = torch.randn(
                (b, p, self.cfg.d_model), generator=gen) * 0.02
            batch["positions"] = mrope_positions(b, self.seq_len, 0)
        if self.cfg.is_encdec:
            batch["frames"] = torch.randn(
                (b, self.seq_len, self.cfg.d_model), generator=gen) * 0.1
        return {k: v.to(self.device) for k, v in batch.items()}


def make_batch_specs(cfg: ModelConfig, shape: ShapeSpec,
                     dtype: torch.dtype = torch.bfloat16
                     ) -> Dict[str, torch.Tensor]:
    """Meta stand-ins for every model input at ``shape`` (the reference's
    ``make_batch_specs``: its keys, shapes and dtypes): ``tokens`` (B, S)
    int32, S = 1 for a decode shape; a vision config's ``vision_embeds``
    (B, P, d) in ``dtype`` outside decode, P = ``_vlm_patches(cfg, S)``;
    an mrope config's ``positions`` (B, S, 3) int32; an encoder-decoder's
    ``frames`` (B, S, d) in ``dtype`` outside decode."""
    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len

    def spec(dims, dt):
        return torch.empty(dims, dtype=dt, device="meta")

    specs = {"tokens": spec((b, s), torch.int32)}
    if cfg.frontend == "vision" and shape.kind != "decode":
        specs["vision_embeds"] = spec((b, _vlm_patches(cfg, s), cfg.d_model),
                                      dtype)
    if cfg.pos_type == "mrope":
        specs["positions"] = spec((b, s, 3), torch.int32)
    if cfg.is_encdec and shape.kind != "decode":
        specs["frames"] = spec((b, s, cfg.d_model), dtype)
    return specs
