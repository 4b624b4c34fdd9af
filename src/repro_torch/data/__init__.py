"""repro_torch.data — seekable synthetic token and request streams."""
from .pipeline import RequestPipeline, TokenPipeline

__all__ = ["RequestPipeline", "TokenPipeline"]
