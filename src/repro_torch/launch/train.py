"""Training launcher: the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \
        --preset full --steps 6 --seq-len 1024 --checkpoint-dir ckpt

Wires together: config zoo → TokenPipeline (seekable) → make_train_step
(remat, grad-accum, optional gradient compression) → CheckpointManager
(async, atomic, keep-k, auto-resume). It runs on the CUDA device unless
``device="cpu"`` (the plain PyTorch versions of the kernels). With
``--compression topk|int8`` each step is split as the reference splits
it: gradients → error-feedback compression with its carry → AdamW.

On a device mesh, call ``run_training(mesh=make_host_mesh(model=m))``
(:mod:`repro_torch.launch.mesh`) in every rank of an initialized process
group (NCCL on the card; gloo with ``device="cpu"``): each rank trains on
its block of every batch (``shard_batch``: its data rank's rows, its
model rank's positions) and its model rank's heads, experts or ``d_ff``
slice, and the losses are the global ones. The CLI runs one
process, as the reference's does.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.convert import reference_leaves
from repro_torch.device import resolve_device
from repro_torch.distributed import ErrorFeedback
from repro_torch.models.layers import MeshContext
from repro_torch.models.transformer import shard_batch
from repro_torch.training import (AdamWConfig, init_train_state,
                                  make_train_step)
from repro_torch.training.trainer import make_grad_and_apply

__all__ = ["run_training"]


def run_training(arch: str = "smollm_360m", preset: str = "tiny",
                 steps: int = 30, global_batch: int = 8, seq_len: int = 64,
                 checkpoint_dir: Optional[str] = None, ckpt_every: int = 10,
                 grad_accum: int = 1, compression: Optional[str] = None,
                 lr: float = 1e-3, seed: int = 0,
                 log_every: int = 10, mesh=None, verbose: bool = True,
                 schedule_steps: int = 0, device=None):
    """Train ``arch`` (``preset`` "tiny": its smoke config, "full": the
    published one) with ``remat=True`` for steps ``start .. steps - 1``,
    resuming from the newest checkpoint in ``checkpoint_dir``. The
    schedule warms up over ``max(2, S // 10)`` of ``S = schedule_steps or
    steps`` total steps. ``compression`` ("topk" or "int8") runs each step
    as ``grad_fn`` → :meth:`ErrorFeedback.transform` (over the
    reference's stacked leaves, with its carry) → ``apply_fn``, the loss
    being ``grad_fn``'s; it ignores ``grad_accum``, as the reference's
    split step does. Returns ``{"losses", "step_s", "state", "config",
    "start_step", "carry"}`` (``step_s``: each step's wall seconds, ended
    by reading its loss on the host; ``carry``: the compression residual,
    ``None`` without compression).

    ``mesh`` (a ``("data", "model")`` DeviceMesh; call in every rank)
    trains with ``MeshContext(mesh, ("data",))``: every rank builds the
    same parameters from ``seed``, keeps the pipeline's global batch on
    the host and moves only its ``shard_batch`` block of it (its block of
    each microbatch with ``grad_accum``) to the mesh's device (this rank's
    card, or the CPU for a gloo mesh), and gets the mesh-summed gradients,
    so the ranks stay identical; compression runs on those gradients. Only
    data rank 0 of model rank 0 writes checkpoints; every rank
    restores."""
    ctx = None
    if mesh is not None:
        ctx = MeshContext(mesh, ("data",))
        if device is None:
            device = mesh.device_type
            if device == "cuda":
                device = torch.device("cuda", torch.cuda.current_device())
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if preset == "tiny" else get_config(arch)
    cfg = cfg.with_(remat=True)
    sched = schedule_steps or steps
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(2, sched // 10),
                          total_steps=max(sched, 10))
    pipe = TokenPipeline(cfg, global_batch=global_batch, seq_len=seq_len,
                         seed=seed)
    accum = 1 if compression else grad_accum

    def batch_at(step: int):
        """The step's global batch on the host, or on a mesh this rank's
        blocks of it."""
        batch = {k: torch.from_numpy(v) for k, v in
                 pipe.batch_at(step).items()}
        return batch if ctx is None else shard_batch(batch, ctx, accum)[0]

    if ctx is not None:     # bound to the pipeline's global batch
        ctx = shard_batch({k: torch.from_numpy(v) for k, v in
                           pipe.batch_at(0).items()}, ctx, accum)[1]
    state = init_train_state(cfg, opt_cfg,
                             torch.Generator(device=dev).manual_seed(seed))
    start_step = 0
    ef = carry = None
    if compression:
        # split step: grads → EF compression (stateful carry) → optimizer
        ef = ErrorFeedback(method=compression,
                           leaves=reference_leaves(state.params))
        grad_fn, apply_fn = make_grad_and_apply(cfg, opt_cfg, ctx)
        carry = ef.init(dict(state.params.named_parameters()))
    else:
        step_fn = make_train_step(cfg, opt_cfg, ctx, grad_accum=grad_accum)

    writer = ctx is None or (ctx.data_index == 0 and ctx.model_index == 0)
    mgr = None
    if checkpoint_dir:
        mgr = CheckpointManager(checkpoint_dir, keep=3, every=ckpt_every)
        restored, state_r = mgr.restore_latest(state)
        if restored is not None:
            start_step, state = restored, state_r
            if verbose:
                print(f"[train] resumed from step {start_step}")

    losses, step_s = [], []
    t0 = time.perf_counter()
    for step in range(start_step, steps):
        t = time.perf_counter()
        batch = {k: v.to(dev) for k, v in batch_at(step).items()}
        if ef is None:
            state, metrics = step_fn(state, batch)
        else:
            loss_v, grads = grad_fn(state.params, batch)
            grads, carry = ef.transform(grads, carry)
            state, metrics = apply_fn(grads, state)
            metrics["loss"] = loss_v
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - t)
        losses.append(loss)
        if mgr and writer:
            mgr.maybe_save(step + 1, state)
        if verbose and (step % log_every == 0 or step == steps - 1):
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"({(time.perf_counter() - t0) / (step - start_step + 1):5.2f}"
                  "s/it)")
    if mgr:
        mgr.wait()
    return {"losses": losses, "step_s": step_s, "state": state,
            "config": cfg, "start_step": start_step, "carry": carry}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compression", default=None,
                    choices=[None, "topk", "int8"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch versions)")
    args = ap.parse_args()
    out = run_training(**{k.replace("-", "_"): v
                          for k, v in vars(args).items()})
    print(f"[train] done; loss {out['losses'][0]:.4f} → "
          f"{out['losses'][-1]:.4f}")


if __name__ == "__main__":
    main()
