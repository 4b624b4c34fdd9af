"""repro_torch — the PIES placement pipeline and its model serving and
training data plane in PyTorch, with hand-written CUDA kernels for Hopper
(sm_90a).

A port of :mod:`repro` that imports neither JAX nor ``repro``. It carries
the paper's main path — instance → QoS (Eqs. 1–6) → sparse EGP (Alg. 3)
→ OMS (Alg. 1) → σ — the serving of a placed model on one CUDA device,
and the training of the dense family:

* :mod:`repro_torch.core` — NumPy host oracles and their torch twins;
* :mod:`repro_torch.kernels.qos_matrix` — dispatchers over the three QoS
  kernels (``csrc/qos_kernels.cu``) and their plain PyTorch versions;
* :mod:`repro_torch.kernels.flash_attention`,
  :mod:`repro_torch.kernels.gqa_decode`, :mod:`repro_torch.kernels.ssd_scan`
  — the attention kernels (``csrc/flash_attention.cu``,
  ``csrc/flash_attention_bwd.cu``, ``csrc/gqa_decode.cu``), the SSD scan
  (``csrc/ssd_scan.cu``) and their plain versions;
* :mod:`repro_torch.workloads` — ``evaluate_sparse`` / ``evaluate_host``;
* :mod:`repro_torch.configs`, :mod:`repro_torch.models` — the model
  configs and the dense, ssm and hybrid families (prefill, decode, caches,
  the training loss);
* :mod:`repro_torch.serving` — the OMS request router and the model
  server;
* :mod:`repro_torch.training`, :mod:`repro_torch.data`,
  :mod:`repro_torch.checkpoint`, :mod:`repro_torch.launch.train` — AdamW,
  the training step (attention's backward through the flash-attention
  backward kernels, ``csrc/flash_attention_bwd.cu``), the seekable token
  pipeline, checkpoints and the training launcher.

Entry points take ``device=None``, which means ``"cuda"``; with no CUDA
device they raise instead of running on the CPU. Pass ``device="cpu"`` to
run the plain versions on the host.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
