"""Mamba2 SSD chunked scan (B8): CUDA kernel, plain versions, dispatcher."""
from .ops import (LAUNCHES, MAX_CHUNK, SHAPES, reset_launch_counts, ssd,
                  ssd_scan_cuda, ssd_scan_cuda_steps)
from .ref import ssd_chunked, ssd_chunked_steps, ssd_scan_ref

__all__ = ["LAUNCHES", "MAX_CHUNK", "SHAPES", "reset_launch_counts", "ssd",
           "ssd_chunked", "ssd_chunked_steps", "ssd_scan_cuda",
           "ssd_scan_cuda_steps", "ssd_scan_ref"]
