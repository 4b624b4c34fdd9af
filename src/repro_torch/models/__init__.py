"""repro_torch.models — the model families of the zoo (dense, MoE, ssm,
hybrid, and the audio and vision frontends; the EI service
implementations' data plane) in PyTorch."""
from . import layers, transformer
from .config import GQAPadding, ModelConfig, pad_to_multiple, plan_gqa_padding
from .transformer import (LM, Cache, cache_spec, decode_step, forward,
                          init_cache, init_params, logits_fn, prefill)

__all__ = ["Cache", "GQAPadding", "LM", "ModelConfig", "cache_spec",
           "decode_step", "forward", "init_cache", "init_params", "layers",
           "logits_fn", "pad_to_multiple", "plan_gqa_padding", "prefill",
           "transformer"]
