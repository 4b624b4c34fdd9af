"""repro_torch.models — the dense model family (the EI service
implementations' data plane) in PyTorch."""
from . import layers, transformer
from .config import GQAPadding, ModelConfig, pad_to_multiple, plan_gqa_padding
from .transformer import (Cache, DenseLM, cache_spec, decode_step, forward,
                          init_cache, init_params, logits_fn, prefill)

__all__ = ["Cache", "DenseLM", "GQAPadding", "ModelConfig", "cache_spec",
           "decode_step", "forward", "init_cache", "init_params", "layers",
           "logits_fn", "pad_to_multiple", "plan_gqa_padding", "prefill",
           "transformer"]
