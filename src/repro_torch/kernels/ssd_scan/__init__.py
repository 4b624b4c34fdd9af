"""Mamba2 SSD chunked scan (B8) and its backward: CUDA kernels, plain
versions, dispatchers and the autograd Function."""
from .ops import (LAUNCHES, MAX_CHUNK, SHAPES, SSDScan, reset_launch_counts,
                  ssd, ssd_scan_bwd, ssd_scan_bwd_cost, ssd_scan_bwd_cuda,
                  ssd_scan_cost, ssd_scan_cuda, ssd_scan_cuda_steps,
                  ssd_scan_work)
from .ref import (ssd_chunked, ssd_chunked_bwd, ssd_chunked_steps,
                  ssd_scan_ref)

__all__ = ["LAUNCHES", "MAX_CHUNK", "SHAPES", "SSDScan",
           "reset_launch_counts", "ssd", "ssd_chunked", "ssd_chunked_bwd",
           "ssd_chunked_steps", "ssd_scan_bwd", "ssd_scan_bwd_cost",
           "ssd_scan_bwd_cuda", "ssd_scan_cost", "ssd_scan_cuda",
           "ssd_scan_cuda_steps", "ssd_scan_ref", "ssd_scan_work"]
