"""repro_torch — the PIES placement pipeline in PyTorch, with hand-written
CUDA kernels for Hopper (sm_90a).

A port of :mod:`repro` that imports neither JAX nor ``repro``. It carries
the paper's main path — instance → QoS (Eqs. 1–6) → sparse EGP (Alg. 3)
→ OMS (Alg. 1) → σ — on one CUDA device:

* :mod:`repro_torch.core` — NumPy host oracles and their torch twins;
* :mod:`repro_torch.kernels.qos_matrix` — dispatchers over the three CUDA
  kernels (``csrc/qos_kernels.cu``) and their plain PyTorch versions;
* :mod:`repro_torch.workloads` — ``evaluate_sparse`` / ``evaluate_host``;
* :mod:`repro_torch.serving.router` — the OMS request router.

Entry points take ``device=None``, which means ``"cuda"``; with no CUDA
device they raise instead of running on the CPU. Pass ``device="cpu"`` to
run the plain versions on the host.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
