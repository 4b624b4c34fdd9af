"""repro_torch — the PIES placement pipeline and its dense-model serving
data plane in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

A port of :mod:`repro` that imports neither JAX nor ``repro``. It carries
the paper's main path — instance → QoS (Eqs. 1–6) → sparse EGP (Alg. 3)
→ OMS (Alg. 1) → σ — and the serving of a placed dense model on one CUDA
device:

* :mod:`repro_torch.core` — NumPy host oracles and their torch twins;
* :mod:`repro_torch.kernels.qos_matrix` — dispatchers over the three QoS
  kernels (``csrc/qos_kernels.cu``) and their plain PyTorch versions;
* :mod:`repro_torch.kernels.flash_attention`,
  :mod:`repro_torch.kernels.gqa_decode` — the prefill and decode attention
  kernels (``csrc/flash_attention.cu``, ``csrc/gqa_decode.cu``) and their
  plain versions;
* :mod:`repro_torch.workloads` — ``evaluate_sparse`` / ``evaluate_host``;
* :mod:`repro_torch.configs`, :mod:`repro_torch.models` — the model
  configs and the dense model family (prefill, decode, KV cache);
* :mod:`repro_torch.serving` — the OMS request router and the model
  server.

Entry points take ``device=None``, which means ``"cuda"``; with no CUDA
device they raise instead of running on the CPU. Pass ``device="cpu"`` to
run the plain versions on the host.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
