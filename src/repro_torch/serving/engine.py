"""Serving data plane: batched prefill + decode of one resident model.

A :class:`ModelServer` holds a model of any ported family
(``repro_torch.models``: dense, ssm, hybrid) at a fixed batch/sequence
bucket and generates greedily: pad the prompts to the bucket's batch,
prefill (flash attention, B4, once per attention layer or shared-block
application; the SSD scan, B8, once per Mamba layer), then decode one token
per step (GQA decode, B7, once per attention application per step; Mamba
layers step their recurrent state in plain PyTorch). It measures wall-clock
prefill and decode time, with ``torch.cuda.synchronize()`` before each
clock read on a CUDA device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

__all__ = ["Request", "BatchResult", "ModelServer"]


@dataclasses.dataclass
class Request:
    uid: int
    service: str
    tokens: np.ndarray           # prompt tokens
    max_new_tokens: int = 8
    alpha: float = 0.0           # accuracy threshold
    delta: float = 1.0           # delay threshold (seconds)
    submitted_at: float = 0.0


@dataclasses.dataclass
class BatchResult:
    uids: List[int]
    outputs: np.ndarray          # [b, new_tokens]
    latency_s: float             # wall time for the whole batch
    prefill_s: float
    decode_s: float


class ModelServer:
    """A resident service implementation: a model at a batch/seq bucket.

    ``params`` defaults to :func:`~repro_torch.models.transformer.init_params`
    from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (``None`` means CUDA). The attention dispatchers follow the device: the
    kernels on CUDA, the plain versions on the CPU.
    """

    def __init__(self, cfg: ModelConfig, params: Optional[T.LM] = None,
                 *, bucket_batch: int = 4, bucket_seq: int = 64,
                 seed: int = 0,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.bucket_batch = bucket_batch
        self.bucket_seq = bucket_seq
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = T.init_params(cfg, gen)
        self.params = params.to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        toks = np.zeros((self.bucket_batch, self.bucket_seq // 2), np.int32)
        self.generate(toks, n_steps=1)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, n_steps: int = 8
                 ) -> Tuple[np.ndarray, float, float]:
        """prompts: ``[b, s]`` int token ids, ``b <= bucket_batch``.
        Returns ``(new_tokens [b, n_steps], prefill_seconds,
        decode_seconds)``. Greedy: the first maximum of the logits over the
        real vocabulary. Raises :class:`ValueError` when the prompt and the
        new tokens do not fit a non-ring KV cache of ``bucket_seq`` slots;
        an ssm model keeps no KV cache and serves past ``bucket_seq``."""
        b, s = prompts.shape
        bb = self.bucket_batch
        if b > bb:
            raise ValueError(f"{b} prompts exceed the batch bucket {bb}")
        cache, ring = T.init_cache(self.cfg, bb, self.bucket_seq,
                                   self.device)
        if cache.has_kv and not ring and s + n_steps > self.bucket_seq:
            raise ValueError(
                f"{s} prompt tokens + {n_steps} new tokens overrun the "
                f"{self.bucket_seq}-slot KV cache (bucket_seq)")
        toks = np.pad(np.asarray(prompts), ((0, bb - b), (0, 0)))
        toks = torch.from_numpy(toks.astype(np.int64)).to(self.device)
        V = self.cfg.vocab_size

        self._sync()
        t0 = time.perf_counter()
        logits, cache = T.prefill(self.params, self.cfg, toks, cache, ring)
        self._sync()
        t1 = time.perf_counter()
        outs = []
        tok = logits[:, :V].argmax(-1)
        for _ in range(n_steps):
            outs.append(tok)
            logits, cache = T.decode_step(self.params, self.cfg, tok, cache,
                                          ring)
            tok = logits[:, :V].argmax(-1)
        self._sync()
        t2 = time.perf_counter()
        new_tokens = torch.stack(outs, dim=1)[:b].cpu().numpy()
        return new_tokens.astype(np.int32), t1 - t0, t2 - t1
