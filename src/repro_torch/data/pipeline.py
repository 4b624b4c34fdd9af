"""Deterministic, seekable data pipelines: the port's own copy of
``repro.data.pipeline`` (NumPy only, byte-identical batches).

Restart/elastic requirements drive the design: ``batch_at(step)`` is a pure
function of ``(seed, step)`` — a replacement worker that joins at step N
produces byte-identical batches without replaying the stream, and a resume
from checkpoint continues exactly where training left off. Sharding is by
slicing the *global* batch, so a re-meshed (smaller-DP) cluster reading the
same steps sees the same global data in more accumulation slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.models.config import ModelConfig

__all__ = ["TokenPipeline", "RequestPipeline"]


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    """Synthetic LM token stream (markov-ish structure so loss can fall)."""

    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        B, S, V = self.global_batch, self.seq_len, self.cfg.vocab_size
        # structured stream: noisy arithmetic sequences mod V — learnable
        start = rng.integers(0, V, size=(B, 1))
        stride = rng.integers(1, 7, size=(B, 1))
        toks = (start + stride * np.arange(S + 1)[None, :]) % V
        noise = rng.random((B, S + 1)) < 0.05
        toks = np.where(noise, rng.integers(0, V, size=(B, S + 1)), toks)
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
            "mask": np.ones((B, S), np.float32),
        }
        if self.cfg.frontend == "audio":
            emb = rng.standard_normal((B, S, self.cfg.d_model)).astype(
                np.float32)
            batch = {"frames": emb,
                     "targets": rng.integers(0, V, (B, S)).astype(np.int32),
                     "mask": np.ones((B, S), np.float32)}
        elif self.cfg.frontend == "vision":
            nv = self.cfg.n_vision_tokens
            batch["tokens"] = batch["tokens"][:, : S - nv]
            batch["patches"] = rng.standard_normal(
                (B, nv, self.cfg.d_model)).astype(np.float32)
        return batch

    def shard(self, batch: Dict[str, np.ndarray], replica: int,
              n_replicas: int) -> Dict[str, np.ndarray]:
        per = self.global_batch // n_replicas
        return {k: v[replica * per:(replica + 1) * per] for k, v in
                batch.items()}


@dataclasses.dataclass(frozen=True)
class RequestPipeline:
    """Synthetic inference-request stream following the paper's §VI-B
    distributions (thresholds α, δ), seekable by tick."""

    n_users: int
    n_services: int
    seq_len: int = 32
    vocab: int = 256
    delta_max: float = 10.0
    seed: int = 0

    def requests_at(self, tick: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, tick]))
        return {
            "service": rng.integers(0, self.n_services, self.n_users),
            "alpha": 1.0 - np.clip(rng.exponential(0.125, self.n_users), 0, 1),
            "delta": np.clip(rng.exponential(1.5, self.n_users), 0,
                             self.delta_max),
            "prompts": rng.integers(
                0, self.vocab, (self.n_users, self.seq_len)).astype(np.int32),
        }
