"""Model configuration for the assigned architecture zoo (the port's own
copy of the JAX package's ``models/config.py``: pure Python, no JAX).

One :class:`ModelConfig` describes any member of the LM family used here:
dense GQA transformers (llama-style, gemma2-style with alternating
local/global attention and logit softcaps), capacity-based MoE, Mamba2 SSD
stacks, Zamba2-style hybrids (Mamba backbone + shared attention blocks),
encoder-only audio backbones and VLM backbones with stub frontends.

Mesh-divisibility padding
-------------------------
The production mesh fixes the tensor-parallel axis at 16 shards. Published
head counts / vocab sizes are not always divisible by 16 (yi: 56Q/8KV,
smollm: 15Q/5KV, internvl2: 14Q/2KV, qwen3: 4KV, hubert vocab 504, mamba2
vocab 50280). Following standard practice (Megatron padded-vocab), we pad
to divisible *physical* shapes with provably-inert dummy slices and keep
the *logical* config exactly as published. :func:`plan_gqa_padding` builds
a padded head layout in which every padded query head maps to a padded
KV slot holding a copy of its original KV head, so attention outputs are
bit-identical to the unpadded model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

__all__ = ["ModelConfig", "GQAPadding", "plan_gqa_padding", "pad_to_multiple"]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class GQAPadding:
    """Padded attention-head layout for a tensor-parallel degree.

    ``q_slot_to_q[i]``  — original query head for padded q slot i (−1 ⇒ dummy)
    ``q_slot_to_kv[i]`` — padded KV slot attended by padded q slot i
    ``kv_slot_to_kv[j]``— original KV head copied into padded kv slot j (−1 ⇒ dummy)
    """
    n_q: int            # original query heads
    n_kv: int           # original KV heads
    n_q_pad: int        # padded query heads (multiple of shards)
    n_kv_pad: int       # padded KV heads (multiple of shards)
    group: int          # uniform padded group size = n_q_pad // n_kv_pad
    q_slot_to_q: Tuple[int, ...]
    q_slot_to_kv: Tuple[int, ...]
    kv_slot_to_kv: Tuple[int, ...]

    @property
    def is_identity(self) -> bool:
        return self.n_q == self.n_q_pad and self.n_kv == self.n_kv_pad


def plan_gqa_padding(n_q: int, n_kv: int, shards: int) -> GQAPadding:
    """Pad (n_q, n_kv) heads so both are divisible by ``shards`` and the
    padded grouping is uniform while preserving the original q→kv map.

    Strategy: pad KV heads to ``n_kv_pad = max(shards, n_kv rounded up)``
    by replicating each original KV head ``rep_i`` times (Σ rep_i covers the
    padded slots); choose uniform group ``G = ceil(g / min_i rep_i)`` with
    ``g = n_q // n_kv`` so each original group of g query heads fits into
    the padded slots pointing at copies of its KV head.
    """
    assert n_q % n_kv == 0, "published GQA configs have uniform groups"
    g = n_q // n_kv
    if n_q % shards == 0 and n_kv % shards == 0:
        ident = GQAPadding(
            n_q, n_kv, n_q, n_kv, g,
            tuple(range(n_q)),
            tuple(i // g for i in range(n_q)),
            tuple(range(n_kv)),
        )
        return ident

    n_kv_pad = pad_to_multiple(max(n_kv, shards), shards) if n_kv < shards \
        else pad_to_multiple(n_kv, shards)
    # distribute padded kv slots over original kv heads as evenly as possible
    base, extra = divmod(n_kv_pad, n_kv)
    reps = [base + (1 if i < extra else 0) for i in range(n_kv)]
    min_rep = min(reps)
    G = math.ceil(g / min_rep)
    n_q_pad = n_kv_pad * G
    # round q padding up to shard multiple too (n_kv_pad is a multiple of
    # shards, so n_q_pad already is as well)
    assert n_q_pad % shards == 0

    kv_slot_to_kv = []
    for i, r in enumerate(reps):
        kv_slot_to_kv.extend([i] * r)
    q_slot_to_q = [-1] * n_q_pad
    q_slot_to_kv = [slot // G for slot in range(n_q_pad)]
    # place original q heads: group i's g query heads go into the q slots of
    # the padded kv slots that copy original kv head i
    slots_of_kv = {}
    for slot, kv in enumerate(kv_slot_to_kv):
        slots_of_kv.setdefault(kv, []).append(slot)
    for kv in range(n_kv):
        q_heads = list(range(kv * g, (kv + 1) * g))
        cursor = 0
        for kv_slot in slots_of_kv[kv]:
            for j in range(G):
                if cursor < len(q_heads):
                    q_slot_to_q[kv_slot * G + j] = q_heads[cursor]
                    cursor += 1
        assert cursor == len(q_heads), "padding plan failed to place q heads"
    pad = GQAPadding(n_q, n_kv, n_q_pad, n_kv_pad, G,
                     tuple(q_slot_to_q), tuple(q_slot_to_kv),
                     tuple(kv_slot_to_kv))
    _validate_padding(pad)
    return pad


def _validate_padding(p: GQAPadding) -> None:
    g = p.n_q // p.n_kv
    placed = [q for q in p.q_slot_to_q if q >= 0]
    assert sorted(placed) == list(range(p.n_q)), "every q head placed once"
    for slot, q in enumerate(p.q_slot_to_q):
        if q >= 0:
            kv_slot = p.q_slot_to_kv[slot]
            assert p.kv_slot_to_kv[kv_slot] == q // g, \
                "padded q slot must see a copy of its original KV head"


# layer kinds used by the block pattern
ATTN_FULL = "full"
ATTN_SWA = "swa"
MAMBA = "mamba"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 ⇒ d_model // n_heads

    # --- block pattern --------------------------------------------------
    #: cycled over layers, entries from {"full", "swa", "mamba"}
    block_pattern: Tuple[str, ...] = (ATTN_FULL,)
    window: int = 4096               # SWA window
    causal: bool = True              # False for encoder-only backbones

    # --- gemma2-style extras --------------------------------------------
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    scale_embed: bool = False        # multiply embeddings by sqrt(d_model)
    post_norms: bool = False         # extra post-attn / post-ffn RMSNorms

    # --- MoE --------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.5

    # --- SSM (Mamba2 / SSD) ----------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4

    # --- hybrid (Zamba2) ---------------------------------------------------
    #: apply a shared attention+MLP block after every k backbone layers
    shared_attn_every: int = 0
    n_shared_blocks: int = 2         # zamba2 alternates 2 shared blocks

    # --- modality frontends (stubs) ----------------------------------------
    frontend: str = "none"           # none | audio | vision
    n_vision_tokens: int = 1024      # VLM: patch tokens inside seq_len

    # --- misc ---------------------------------------------------------------
    encoder_only: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    act: str = "silu"                # silu | gelu

    # --- numerics / distribution -------------------------------------------
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"     # master params
    opt_state_dtype: str = "float32" # adam m/v
    remat: bool = True
    #: remat policy of the attention stack: "nothing" rematerializes the
    #: whole layer; "save_attn" keeps each layer's attention output (and
    #: B4's lse) across its backward, so the recompute runs no second B4,
    #: at the cost of one [B, S, Hq, hd] tensor per layer held until its
    #: backward. The Mamba layers and shared blocks recompute everything
    #: under either policy. Phase 21 of chip_smoke.py reads both policies
    #: on gemma2-27b at 2 of its 46 layers, 8 x 1,024 tokens a step (NVIDIA
    #: H100 80GB HBM3, 700.00 W): bit-equal gradients, B4 2 launches a
    #: step instead of 4, step 581.79 ms against 584.63 in one run and
    #: 583.94 against 584.51 in another (B4 is under 1 % of the step),
    #: peak memory 60.68 GB against 60.55.
    remat_policy: str = "nothing"
    tp_shards: int = 1               # tensor-parallel degree to pad for

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def gqa(self) -> GQAPadding:
        if self.n_heads == 0:
            return plan_gqa_padding(1, 1, 1)
        return plan_gqa_padding(self.n_heads, self.n_kv_heads,
                                max(self.tp_shards, 1))

    @property
    def vocab_pad(self) -> int:
        return pad_to_multiple(self.vocab_size, max(self.tp_shards, 1) * 8)

    @property
    def d_ff_pad(self) -> int:
        return pad_to_multiple(self.d_ff, max(self.tp_shards, 1)) if self.d_ff else 0

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.layer_kind(i) for i in range(self.n_layers))

    @property
    def uses_attention(self) -> bool:
        return any(k != MAMBA for k in self.layer_kinds) or self.shared_attn_every > 0

    @property
    def uses_mamba(self) -> bool:
        return any(k == MAMBA for k in self.layer_kinds)

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """True when decode state does not grow linearly with *unbounded*
        full-attention KV (SSM / hybrid / SWA-only archs)."""
        kinds = set(self.layer_kinds)
        if self.shared_attn_every > 0:
            return True  # hybrid: periodic attention, Mamba backbone
        return ATTN_FULL not in kinds

    @property
    def n_params(self) -> int:
        """Logical (unpadded) parameter count, embedding included."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        total = V * D  # embedding
        if not self.tie_embeddings and not self.encoder_only:
            total += D * V
        if self.encoder_only:
            total += D * V  # classifier head
        hd = self.head_dim
        attn = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd \
            + self.n_heads * hd * D
        if self.n_experts:
            ffn = self.n_experts * 3 * D * F + D * self.n_experts  # router
        else:
            ffn = 3 * D * F
        mamba = 0
        if self.uses_mamba:
            din, N = self.d_inner, self.ssm_state
            # in_proj: z, x, B, C, dt  (B/C single group of size N)
            mamba = D * (2 * din + 2 * N + self.ssm_heads) + din * D \
                + self.conv_width * (din + 2 * N) + 3 * self.ssm_heads
        for kind in self.layer_kinds:
            if kind == MAMBA:
                total += mamba
            else:
                total += attn + (ffn if not self.n_experts else 0)
            if self.n_experts and kind != MAMBA:
                total += ffn
        if self.shared_attn_every:
            n_apps = self.n_layers // self.shared_attn_every
            total += self.n_shared_blocks * (attn + 3 * D * self.d_ff)
        total += self.n_layers * 2 * D  # norms (approx)
        return total

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.n_experts:
            return self.n_params
        D, F = self.d_model, self.d_ff
        dense_total = self.n_params - self.n_layers * self.n_experts * 3 * D * F
        return dense_total + self.n_layers * self.top_k * 3 * D * F

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
