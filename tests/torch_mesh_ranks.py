"""The rank side of the port's mesh tests (tests/test_torch_mesh*.py): the
cases, a spawner of gloo ranks with a deadline, and the work each rank
does. Imports torch and repro_torch only (a spawned rank imports this
module, never JAX); the reference's side is tests/torch_mesh_reference.py,
which writes what the ranks compare against into one ``.npz``."""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

#: float32 forward, loss and gradient tolerances (the forward absolute, the
#: loss relative, a gradient leaf relative to its largest |value|); the
#: step tolerances of tests/test_integration.py for run_training's losses
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
FIRST_STEP_TOL, STEP_TOL = 1e-4, 2e-3
#: seconds a spawn of ranks may take before it is killed and fails
SPAWN_TIMEOUT = 240


class Case(NamedTuple):
    """One configuration on one mesh shape: the smoke config of ``arch``
    with ``over``, in float32 with remat, ``B x S`` tokens of the
    pipeline's batch 0 (seed 1), run with each ``sp_matmuls`` in
    ``sps``; the loss and gradients over ``accum`` microbatches (the
    reference's ``make_train_step`` order: global rows ``[i · B/accum,
    (i+1) · B/accum)``, each split over the data axis)."""
    name: str
    arch: str
    over: Tuple
    shape: Tuple[int, int]
    sps: Tuple[bool, ...]
    B: int = 4
    S: int = 40
    accum: int = 1


MODEL_CASES = (
    Case("yi_41", "yi_34b", (), (4, 1), (False, True)),
    Case("yi_22", "yi_34b", (), (2, 2), (False, True)),
    Case("mixtral_41", "mixtral_8x7b", (), (4, 1), (False, True)),
    Case("mixtral_22", "mixtral_8x7b", (), (2, 2), (False, True)),
    # tp mode: 6 experts over a 4-rank model axis, d_ff 96 split in 4
    Case("mixtral_tp_14", "mixtral_8x7b", (("n_experts", 6),), (1, 4),
         (False,)),
    # 3 query heads, 1 KV head: the whole block on each model rank
    Case("smollm_22", "smollm_360m", (), (2, 2), (False,)),
    # 8 x 520 > 4,096 tokens: the vocab-parallel embedding
    Case("yi_vocab_22", "yi_34b", (), (2, 2), (True,), 8, 520),
    # per-data-shard capacity that drops assignments (T_local = 320)
    Case("mixtral_drops_22", "mixtral_8x7b", (("capacity_factor", 0.5),),
         (2, 2), (False,), 4, 160),
    # two microbatches of 2 rows, a row a data rank: a data rank routes
    # global rows 0 and 2, or 1 and 3, at the capacity of 160 tokens
    Case("mixtral_accum_22", "mixtral_8x7b", (("capacity_factor", 0.5),),
         (2, 2), (False,), 4, 160, accum=2),
)
SSM_CASES = (
    Case("mamba2_41", "mamba2_2p7b", (), (4, 1), (False,)),
    Case("zamba2_41", "zamba2_2p7b", (), (4, 1), (False, True)),
)
#: the tensor-parallel Mamba block: the smoke configs' 8 SSM heads over 2
#: and 4 model ranks; 6 heads (d_inner 192 in heads of 32) over 4 do not
#: divide, and each model rank runs the whole block
TP_CASES = (
    Case("mamba2_22", "mamba2_2p7b", (), (2, 2), (False, True)),
    Case("mamba2_14", "mamba2_2p7b", (), (1, 4), (False, True)),
    Case("zamba2_22", "zamba2_2p7b", (), (2, 2), (False, True)),
    Case("zamba2_14", "zamba2_2p7b", (), (1, 4), (False, True)),
    Case("mamba2_h6_14", "mamba2_2p7b",
         (("ssm_expand", 3), ("ssm_head_dim", 32)), (1, 4), (False,)),
)
#: the frontends with the sequence split: hubert's frames, internvl2's 8
#: patches before 32 tokens (its 1 KV head: no SP, the whole attention on
#: each model rank)
FRONTEND_CASES = (
    Case("hubert_22", "hubert_xlarge", (), (2, 2), (False, True)),
    Case("internvl2_22", "internvl2_1b", (), (2, 2), (False,)),
)
#: run_training(mesh=..., steps=3) cases: (arch, mesh shape, compression)
TRAIN_CASES = (("mixtral_8x7b", (4, 1), None), ("mixtral_8x7b", (2, 2), None),
               ("smollm_360m", (2, 2), "topk"))


#: the sharded training state against the replicated one: (arch, mesh
#: shape), SHARD_STEPS float32 steps of the smoke config on SHARD_B x
#: SHARD_S tokens, after which every block is bit-equal to the same block
#: of the replicated state
SHARD_CASES = tuple((a, s) for a in ("smollm_360m", "mixtral_8x7b",
                                     "mamba2_2p7b", "zamba2_2p7b")
                    for s in ((4, 1), (2, 2), (1, 4)))
SHARD_STEPS, SHARD_B, SHARD_S = 3, 4, 40
#: the same on the SP path (sp_matmuls) with a vocab-parallel lookup of an
#: untied table (SHARD_SP_B x SHARD_SP_S above 4,096 tokens): the FSDP
#: blocks that the SP projections, the MoE and the lookup gather, and the
#: table's vocabulary rows, used as stored
SHARD_SP_CASES = (("yi_34b", (4, 1)), ("yi_34b", (2, 2)),
                  ("mixtral_8x7b", (2, 2)))
SHARD_SP_B, SHARD_SP_S = 8, 520
#: the bfloat16 loss of mixtral's smoke config on a mesh against one
#: device's, in both packages (tests/torch_mesh_bf16_gap.py): the model
#: ranks' partial outputs are each rounded to bfloat16 before their psum.
#: The smoke config with mixtral-8x7b's ratios (32/8 heads, 8 experts), so
#: that the heads and experts divide a model axis of 4
GAP_ARCH, GAP_B, GAP_S = "mixtral_8x7b", 8, 64
GAP_OVER = (("n_heads", 16), ("n_kv_heads", 4), ("n_experts", 8))
GAP_SHAPES = ((1, 2), (1, 4))
#: the state written, restored and passed between the packages
CKPT_ARCH, CKPT_STEP = "mamba2_2p7b", 3


class ServeCase(NamedTuple):
    """Prefill and greedy decode of the smoke config of ``arch`` with
    ``over``, in float32, on one mesh shape: ``B`` rows of SERVE_S tokens
    (a vision model's SERVE_PATCHES patch embeddings before them), then
    SERVE_STEPS decode steps; ``sp`` the prefill's ``sp_matmuls``;
    ``blocks``: the port also serves the model stored as each rank's
    blocks (``shard_module``); ``shard_seq``: a batch-1 prefill, then the
    cache's KV slots laid over the batch axes for the decode steps (the
    reference's ``_cache_struct(..., shard_seq_cache=True)``). An
    encoder-only model (hubert) runs its mesh prefill: ``forward`` and
    ``logits_fn`` of SERVE_S frames."""
    name: str
    arch: str
    over: Tuple
    shape: Tuple[int, int]
    sp: bool = False
    B: int = 4
    blocks: bool = False
    shard_seq: bool = False


#: serving on a mesh: every family (mixtral's window of 8 under the
#: 16-token prompt, so its ring of 8 slots wraps; tp mode with 6 experts
#: over 4 model ranks), each of the three mesh shapes, one SP prefill, one
#: model stored as blocks, and batch 1 with the KV slots over data = 4
SERVE_S, SERVE_STEPS, SERVE_PATCHES = 16, 3, 8
SERVE_CASES = (
    ServeCase("smollm_22", "smollm_360m", (), (2, 2)),
    ServeCase("yi_41", "yi_34b", (), (4, 1)),
    ServeCase("yi_14", "yi_34b", (), (1, 4)),
    ServeCase("yi_sp_22", "yi_34b", (), (2, 2), sp=True),
    ServeCase("gemma2_41", "gemma2_27b", (), (4, 1)),
    ServeCase("mixtral_22", "mixtral_8x7b", (("window", 8),), (2, 2)),
    ServeCase("mixtral_tp_14", "mixtral_8x7b",
              (("window", 8), ("n_experts", 6)), (1, 4)),
    ServeCase("mamba2_41", "mamba2_2p7b", (), (4, 1)),
    ServeCase("mamba2_14", "mamba2_2p7b", (), (1, 4)),
    ServeCase("zamba2_22", "zamba2_2p7b", (), (2, 2), blocks=True),
    ServeCase("zamba2_14", "zamba2_2p7b", (), (1, 4)),
    ServeCase("internvl2_22", "internvl2_1b", (), (2, 2)),
    ServeCase("hubert_22", "hubert_xlarge", (), (2, 2)),
    ServeCase("mixtral_seq_41", "mixtral_8x7b", (("window", 8),), (4, 1),
              B=1, shard_seq=True),
    ServeCase("zamba2_seq_41", "zamba2_2p7b", (), (4, 1), B=1,
              shard_seq=True),
)
#: the psum witness: four seeded bf16 rows of PSUM_N elements
PSUM_N = 65536
#: logits within SERVE_TOL of the reference's largest |logit|, every cache
#: field (gathered whole) within SERVE_TOL of its largest |value|
SERVE_TOL = 1e-5


def serve_config(case: ServeCase, cfg):
    return cfg.with_(dtype="float32", **dict(case.over))


def serve_max_seq(case: ServeCase, cfg) -> int:
    """The cache's slots: the prompt and the decode steps, rounded up to a
    multiple of 4 (so that a batch-1 cache's slots split over 4 data
    ranks)."""
    n = SERVE_S + (SERVE_PATCHES if cfg.frontend == "vision" else 0) \
        + SERVE_STEPS
    return -(-n // 4) * 4


def serve_inputs(case: ServeCase, cfg, seed: int = 2) -> Dict[str, np.ndarray]:
    """The case's prompt from NumPy: ``tokens [B, S]``, or an audio
    model's ``frames [B, S, D]``; a vision model's ``patches``."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal(
            (case.B, SERVE_S, cfg.d_model)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (case.B, SERVE_S),
                                  dtype=np.int32)}
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (case.B, SERVE_PATCHES, cfg.d_model)).astype(np.float32)
    return out


def train_key(arch: str, shape: Tuple[int, int], compression) -> str:
    return f"{arch}_{shape[0]}{shape[1]}" + (f"_{compression}"
                                             if compression else "")
TRAIN_KW = dict(steps=3, global_batch=4, seq_len=32, seed=1)


def case_config(case: Case, cfg):
    return cfg.with_(dtype="float32", remat=True, **dict(case.over))


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays as ``{"a/b/c": array}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def unflatten(flat: Dict[str, np.ndarray], prefix: str) -> Dict:
    """The nested dict under ``prefix`` of :func:`flatten`'s keys."""
    tree: Dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node, parts = tree, key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


# ---------------------------------------------------------------------------
# the reference's subprocess and the ranks' spawn
# ---------------------------------------------------------------------------

def _reference_cmd(tmp: str, part: str):
    here = Path(__file__).resolve().parent
    path = os.path.join(tmp, f"ref_{part}.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(here.parent / "src"), os.environ.get("PYTHONPATH",
                                                             "")]))
    return [sys.executable, str(here / "torch_mesh_reference.py"), path,
            part], env, path


def run_reference(tmp: str, part: str) -> str:
    """tests/torch_mesh_reference.py's ``part`` ("models" or "train") in
    one subprocess on a 4-device host platform; the path of its
    ``.npz``."""
    cmd, env, path = _reference_cmd(tmp, part)
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=SPAWN_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return path


class Reference:
    """tests/torch_mesh_reference.py's ``part`` started in the background
    (its output to a log file), so that the port's ranks run beside it."""

    def __init__(self, tmp: str, part: str):
        cmd, env, self.path = _reference_cmd(tmp, part)
        self.log = open(os.path.join(tmp, f"ref_{part}.log"), "w+")
        self.deadline = time.monotonic() + SPAWN_TIMEOUT
        self.proc = subprocess.Popen(cmd, env=env, stdout=self.log,
                                     stderr=subprocess.STDOUT)

    def _failed(self) -> str:
        self.log.seek(0)
        return self.log.read()[-4000:]

    def wait_for(self, path: str) -> str:
        """``path`` once the reference has written it."""
        while not os.path.exists(path):
            if self.proc.poll() is not None or \
                    time.monotonic() > self.deadline:
                self.close()
                raise AssertionError(f"the reference wrote no {path}: "
                                     + self._failed())
            time.sleep(0.2)
        return path

    def result(self) -> str:
        """The ``.npz`` path once the reference has ended."""
        try:
            rc = self.proc.wait(timeout=max(1.0, self.deadline
                                            - time.monotonic()))
        finally:
            self.close()
        assert rc == 0, self._failed()
        return self.path

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _entry(rank: int, fn, world: int, tmp: str, args) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            world_size=world, rank=rank)
    try:
        out = fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn, world: int, tmp: str, *args, timeout: float = SPAWN_TIMEOUT):
    """Run ``fn(rank, *args)`` in ``world`` gloo ranks (spawned processes,
    the default process group initialized and destroyed around it); the
    ranks' return values in rank order. A rank that raises fails the
    spawn (the others are terminated); so does the deadline."""
    import torch.multiprocessing as mp

    os.makedirs(tmp, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(fn, world, tmp, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    outs = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


# ---------------------------------------------------------------------------
# the ranks' work
# ---------------------------------------------------------------------------

def _batch(cfg, B: int, S: int) -> Dict[str, torch.Tensor]:
    from repro_torch.data import TokenPipeline

    return {k: torch.from_numpy(v) for k, v in TokenPipeline(
        cfg, global_batch=B, seq_len=S, seed=1).batch_at(0).items()}


def _leaf_errs(grads: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
               ) -> Dict[str, float]:
    """Each leaf's max |grad − ref| over the ref's largest |value| (0 where
    both are zero)."""
    out = {}
    for name, r in ref.items():
        r = r.detach()
        scale = float(r.abs().max())
        err = float((grads[name] - r).abs().max())
        out[name] = err / scale if scale else err
    return out


def _gathered(ctx, x: torch.Tensor) -> torch.Tensor:
    """The global ``[B, S, D]`` of a stream block."""
    from repro_torch.models.layers import cst

    return cst(ctx, x, None, None, None, frm=ctx.stream())


def coord(ctx) -> str:
    """This rank's mesh coordinate as the reference's ``.npz`` keys
    write it: ``"<data index><model index>"``."""
    return f"{ctx.data_index}{ctx.model_index}"


def _inputs_vs(blocks: Dict[str, torch.Tensor], ref, prefix: str
               ) -> Dict[str, bool]:
    """Each ``shard_batch`` block against the reference's addressable
    shard of it on this rank's device (``prefix<key>``): bit-equal, and
    the same shape."""
    return {k: ref[prefix + k].shape == tuple(t.shape)
            and bool(np.array_equal(ref[prefix + k], t.numpy()))
            for k, t in blocks.items()}


def _refuses_global(fn) -> bool:
    """Whether ``fn()`` (a mesh call given the global inputs) raises
    ValueError."""
    try:
        fn()
    except ValueError:
        return True
    return False


def model_case(rank: int, case: Case, ref_path: str) -> Dict:
    """Forward, loss and gradients of ``case`` on this rank's mesh with
    each ``sp_matmuls``, against the reference's Auto-mesh results and the
    port's one-device gradient of the same rows as one microbatch a data
    rank (``grad_accum``: the mesh's MoE routes each data rank's tokens
    with their own capacity; every row holds as many tokens, so the mean
    of the microbatches' losses is the mesh's loss). Returns the errors,
    the rank's collective counts and a digest of its reduced
    gradients."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import model_params_from_jax
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import MeshContext
    from repro_torch.training.trainer import _grads, param_tree

    ref = dict(np.load(ref_path))
    cfg = case_config(case, get_smoke_config(case.arch))
    model = model_params_from_jax(cfg, unflatten(ref, f"{case.name}/params/"))
    batch = _batch(cfg, case.B, case.S)
    _, g = _grads(model, cfg, batch, case.shape[0] * case.accum)
    one = {n: t.clone() for n, t in g.items()}
    mesh = make_host_mesh(model=case.shape[1], device="cpu")
    out: Dict = {}
    for sp in case.sps:
        key = f"{case.name}/sp{int(sp)}"
        ctx = MeshContext(mesh, ("data",), sp_matmuls=sp)
        blocks, bctx = T.shard_batch(batch, ctx)
        inputs = {k: blocks[k] for k in ("frames", "patches")
                  if k in blocks}
        C.reset_counts()
        with _scanned_heads() as heads:
            with torch.no_grad():
                x = T.forward(model, cfg, blocks.get("tokens"), ctx=bctx,
                              **inputs)
                xg = _gathered(bctx, x)
            if case.accum > 1:
                blocks, bctx = T.shard_batch(batch, ctx, case.accum)
            loss, grads = _grads(model, cfg, blocks, case.accum, bctx)
        want = param_tree(model_params_from_jax(
            cfg, unflatten(ref, f"{case.name}/grads/")))
        digest = torch.stack([g.double().sum() for g in grads.values()])
        at = f"{case.name}/blocks/{coord(ctx)}/"
        decode = {"tokens": batch["tokens"][:, 0]} if "tokens" in batch \
            else {}
        out[sp] = dict(
            fwd=float((xg - torch.from_numpy(ref[f"{key}/x"])).abs().max()),
            local_shape=tuple(x.shape),
            blocks=_inputs_vs(T.shard_batch(batch, ctx)[0], ref, at + "a1/"),
            accum_blocks=_inputs_vs(T.shard_batch(batch, ctx, 2)[0], ref,
                                    at + "a2/"),
            decode_blocks=_inputs_vs(T.shard_batch(decode, ctx)[0], ref,
                                     at + "decode/") if decode else {},
            global_refused=_refuses_global(lambda: T.forward(
                model, cfg, batch.get("tokens"), ctx=bctx,
                **{k: batch[k] for k in ("frames", "patches")
                   if k in batch})),
            loss=float(loss), ref_loss=float(ref[f"{case.name}/loss"]),
            vs_ref=_leaf_errs(grads, want),
            vs_one=_leaf_errs(grads, one),
            counts={op: dict(c) for op, c in C.COUNTS.items()},
            scan_heads=sorted(set(heads)), digest=digest.numpy())
    return out


class _scanned_heads:
    """Records the head count of every SSD scan the model layers run
    (``models.layers.ssd``) while it is entered."""

    def __enter__(self):
        from repro_torch.models import layers

        self.heads, self.orig = [], layers.ssd

        def spy(x, *args, **kw):
            self.heads.append(int(x.shape[2]))
            return self.orig(x, *args, **kw)

        layers.ssd = spy
        return self.heads

    def __exit__(self, *exc):
        from repro_torch.models import layers

        layers.ssd = self.orig


def gap_case(rank: int, ref_path: str, shape) -> Dict:
    """The port's side of tests/torch_mesh_bf16_gap.py: GAP_ARCH's
    bfloat16 ``loss_fn`` from the reference's parameters on one device and
    on this spawn's ``shape`` mesh with ``sp_matmuls``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import model_params_from_jax
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import MeshContext

    ref = dict(np.load(ref_path))
    cfg = get_smoke_config(GAP_ARCH).with_(remat=True, **dict(GAP_OVER))
    model = model_params_from_jax(cfg, unflatten(ref, "gap/params/"))
    batch = _batch(cfg, GAP_B, GAP_S)
    ctx = MeshContext(make_host_mesh(model=shape[1], device="cpu"),
                      ("data",), sp_matmuls=True)
    blocks, ctx = T.shard_batch(batch, ctx)
    with torch.no_grad():
        return dict(one=float(T.loss_fn(model, cfg, batch)),
                    mesh=float(T.loss_fn(model, cfg, blocks, ctx=ctx)))


def _serve_run(model, cfg, case: ServeCase, ctx, inputs: Dict) -> Dict:
    """The case's prefill and SERVE_STEPS greedy decode steps on ``ctx``'s
    mesh from this rank's ``shard_batch`` blocks: the logits gathered whole
    and this rank's block of them, this rank's cache block shapes, the
    whole cache after the prefill and after the last step, the greedy
    tokens (``argmax`` of the gathered logits, fed back as each rank's
    block), the collectives' calls of one decode step, and every B7
    call's (cache slots, slot0, sc_total) on the model layer."""
    from repro_torch.distributed import collectives as C
    from repro_torch.models import layers
    from repro_torch.models import transformer as T

    def whole(cache):
        w = T.gather_cache(cache, ctx)
        return {f: getattr(w, f).numpy().copy()
                for f in ("kv_k", "kv_v", "conv", "ssm")}

    out: Dict = {}
    blocks, pctx = T.shard_batch(inputs, ctx)
    cache, ring = T.init_cache(cfg, case.B, serve_max_seq(case, cfg), "cpu",
                               ctx=pctx)
    out["block_shapes"] = {f: tuple(getattr(cache, f).shape)
                           for f in ("kv_k", "conv", "ssm")}
    logits, cache = T.prefill(model, cfg, blocks.get("tokens"), cache, ring,
                              patches=blocks.get("patches"), ctx=pctx)
    out["prefill"] = dict(logits=T.gather_logits(logits, pctx, cfg).numpy()
                          .copy(), **whole(cache))
    out["prefill_block"] = logits.numpy().copy()
    if case.shard_seq:
        cache = T.shard_cache(cache, ctx)
        out["seq_block_shapes"] = {f: tuple(getattr(cache, f).shape)
                                   for f in ("kv_k", "conv", "ssm")}
        fresh, _ = T.init_cache(cfg, case.B, serve_max_seq(case, cfg),
                                "cpu", ctx=ctx, shard_seq=True)
        out["seq_init_same"] = fresh.layout == cache.layout and all(
            getattr(fresh, f).shape == getattr(cache, f).shape
            for f in ("kv_k", "kv_v", "conv", "ssm"))
    calls, orig = [], layers.decode_attention

    def spy(q, kc, *a, **kw):
        calls.append((int(kc.shape[1]), kw.get("slot0", 0),
                      kw.get("sc_total")))
        return orig(q, kc, *a, **kw)

    toks = [torch.from_numpy(out["prefill"]["logits"]).argmax(-1)]
    layers.decode_attention = spy
    try:
        for i in range(SERVE_STEPS):
            step_in, dctx = T.shard_batch({"tokens": toks[-1]}, ctx)
            C.reset_counts()
            logits, cache = T.decode_step(model, cfg, step_in["tokens"],
                                          cache, ring, ctx=dctx)
            out["step_counts"] = {op: dict(c) for op, c in C.COUNTS.items()}
            full = T.gather_logits(logits, dctx, cfg)
            out[f"step{i}"] = full.numpy().copy()
            out[f"step{i}_block"] = logits.numpy().copy()
            toks.append(full.argmax(-1))
    finally:
        layers.decode_attention = orig
    out["last"] = dict(logits=full.numpy().copy(), **whole(cache))
    out["tokens"] = torch.stack(toks).numpy()
    out["b7"] = sorted(set(calls))
    out["coord"] = coord(ctx)
    return out


def serve_cases(rank: int, cases, inputs_path: str) -> Dict:
    """The port's side of tests/test_torch_mesh_serve.py: each SERVE_CASES
    case of this spawn's mesh shape from the reference's parameters and
    prompt (:func:`_serve_run`; an encoder-only model's ``forward`` and
    ``logits_fn``, its stream block and gathered whole); a ``blocks`` case
    again with the model stored as this rank's blocks (``shard_module``);
    whether a cache made without the mesh is refused on it, and whether
    the global prompt is."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import model_params_from_jax
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import MeshContext, cst, shard_module

    inputs_all = dict(np.load(inputs_path))
    out: Dict = {}
    mesh = None
    for case in cases:
        cfg = serve_config(case, get_smoke_config(case.arch))
        model = model_params_from_jax(
            cfg, unflatten(inputs_all, f"{case.name}/params/"))
        pre = f"{case.name}/input/"
        inputs = {k[len(pre):]: torch.from_numpy(v)
                  for k, v in inputs_all.items() if k.startswith(pre)}
        if mesh is None:
            mesh = make_host_mesh(model=case.shape[1], device="cpu")
        ctx = MeshContext(mesh, ("data",), sp_matmuls=case.sp)
        blocks, pctx = T.shard_batch(inputs, ctx)
        if cfg.encoder_only:
            with torch.no_grad():
                x = T.forward(model, cfg, frames=blocks["frames"], ctx=pctx)
                logits = T.logits_fn(T._local_model(model, cfg, pctx), cfg,
                                     x)
                whole = cst(pctx, logits, None, None, None,
                            frm=pctx.stream())
            out[case.name] = dict(logits=whole.numpy().copy(),
                                  block=logits.numpy().copy(),
                                  coord=coord(ctx))
            continue
        out[case.name] = _serve_run(model, cfg, case, ctx, inputs)
        if case.blocks:
            stored = shard_module(model, T.leaf_pspecs(model, cfg), ctx)
            out[case.name]["blocks"] = _serve_run(stored, cfg, case, ctx,
                                                  inputs)
        cache, ring = T.init_cache(cfg, case.B, serve_max_seq(case, cfg),
                                   "cpu")
        out[case.name]["refused"] = _refuses_global(lambda: T.prefill(
            model, cfg, blocks.get("tokens"), cache, ring,
            patches=blocks.get("patches"), ctx=pctx))
        cache, ring = T.init_cache(cfg, case.B, serve_max_seq(case, cfg),
                                   "cpu", ctx=pctx)
        out[case.name]["global_refused"] = _refuses_global(
            lambda: T.prefill(model, cfg, inputs.get("tokens"), cache, ring,
                              patches=inputs.get("patches"), ctx=pctx))
    return out


def psum_case(rank: int, inputs_path: str) -> Dict:
    """The bf16 witness of the psum repair on a (1, 4) mesh: this rank's
    row of the reference's seeded ``[4, 65536]`` bf16 array through the
    port's ``psum`` and ``psum_scatter`` over the model axis, and the old
    running bf16 sum of the four rows (a control)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_host_mesh

    rows = torch.from_numpy(dict(np.load(inputs_path))["psum/x"]).to(
        torch.bfloat16)
    mesh = make_host_mesh(model=4, device="cpu")
    x = rows[C.axis_index("model", mesh=mesh)]
    running = rows[0]
    for r in range(1, 4):
        running = running + rows[r]
    return dict(psum=C.psum(x, "model", mesh=mesh).float().numpy(),
                scatter=C.psum_scatter(x, "model", 0, mesh=mesh).float()
                .numpy(), running=running.float().numpy())


def model_cases(rank: int, cases, ref_path: str) -> Dict:
    return {c.name: model_case(rank, c, ref_path) for c in cases}


def jobs(rank: int, *work) -> Dict:
    """Several of this module's rank functions in one spawn: ``work`` is
    ``(key, function name, args)`` triples; their results by key."""
    return {key: globals()[fn](rank, *args) for key, fn, args in work}


def train_cases(rank: int, cases, ref_path: str, ckpt: str) -> Dict:
    """run_training(mesh=...) from the reference's initial parameters
    (the port's initializer replaced by them), with compression where the
    case says, then (the last case's model, no compression) a checkpoint
    that data rank 0 of model rank 0 writes and every rank restores."""
    import repro_torch.launch.train as LT
    from repro_torch.convert import model_params_from_jax
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import (TrainState, adamw_init, param_tree)

    ref = dict(np.load(ref_path))
    orig = LT.init_train_state
    out = {}
    try:
        for arch, shape, compression in cases:
            name = train_key(arch, shape, compression)

            def reference_init(cfg, opt_cfg, generator, arch=arch):
                model = model_params_from_jax(
                    cfg, unflatten(ref, f"train/{arch}/params/"),
                    device=generator.device)
                return TrainState(model, adamw_init(param_tree(model),
                                                    opt_cfg))

            LT.init_train_state = reference_init
            mesh = make_host_mesh(model=shape[1], device="cpu")
            run = LT.run_training(arch=arch, mesh=mesh, device="cpu",
                                  compression=compression, verbose=False,
                                  **TRAIN_KW)
            params = param_tree(run["state"].params)
            out[name] = dict(losses=run["losses"], want=ref[f"train/{name}"],
                             digest=np.array([float(p.detach().double().sum())
                                              for p in params.values()]))
        # checkpoints: three steps saved by one rank, every rank resumes
        arch, shape, _ = cases[-1]
        mesh = make_host_mesh(model=shape[1], device="cpu")
        kw = dict(TRAIN_KW, arch=arch, mesh=mesh, device="cpu",
                  verbose=False, checkpoint_dir=ckpt, ckpt_every=3)
        first = LT.run_training(**kw)
        import torch.distributed as dist
        dist.barrier()
        written = sorted(os.listdir(ckpt))
        again = LT.run_training(**dict(kw, steps=4))
        out["resume"] = dict(written=written,
                             start_step=again["start_step"],
                             losses=first["losses"] + again["losses"])
    finally:
        LT.init_train_state = orig
    return out


def compressed_psum_case(rank: int) -> Dict:
    """``compressed_psum`` over each axis against the rank-order sum of
    ``int8_round`` outputs fed the same draws, recomputed here for every
    rank; ``method="none"`` against ``psum``; the autograd collectives'
    forward and backward against one-process sums; a sweep mesh over the
    first two ranks."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import compressed_psum, int8_round
    from repro_torch.launch.mesh import make_host_mesh, make_sweep_mesh

    mesh = make_host_mesh(model=2, device="cpu")
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")

    def x_of(r):
        return torch.randn(5, 7, generator=torch.Generator().manual_seed(
            100 + r), dtype=torch.float32) * (r + 1)

    def draws_of(r):
        return torch.rand(5, 7, generator=torch.Generator().manual_seed(
            200 + r), dtype=torch.float32)

    out = {}
    with C.use_mesh(mesh):
        for axis, line in (("data", [m, 2 + m]), ("model", [2 * d, 2 * d + 1]),
                           (("data", "model"), [0, 1, 2, 3])):
            got = compressed_psum(x_of(rank), axis,
                                  torch.Generator().manual_seed(200 + rank))
            want = None
            for r in line:
                q = int8_round(x_of(r), draws_of(r))[0]
                want = q if want is None else want + q
            plain = compressed_psum(x_of(rank), axis, torch.Generator(),
                                    method="none")
            psum_want = None
            for r in line:
                psum_want = x_of(r) if psum_want is None \
                    else psum_want + x_of(r)
            out[str(axis)] = dict(int8=bool(torch.equal(got, want)),
                                  none=bool(torch.equal(plain, psum_want)))
        # autograd: d/dx of Σ_r <w_r, op(x)_r> on every rank's own copy
        x = x_of(rank).requires_grad_(True)
        w = {r: draws_of(r) for r in range(4)}
        model_line = [2 * d, 2 * d + 1]
        y = C.all_gather(x, "model", 1)               # [5, 14]
        (y * torch.cat([w[r] for r in [rank]] * 2, 1)).sum().backward()
        # Σ over the line of rank r's weight block for this rank's slot
        want = sum(w[r] for r in model_line)
        out["all_gather_bwd"] = bool(torch.equal(x.grad, want))
        x.grad = None
        stacked = C.all_gather(x_of(rank), "model", 0, tiled=False)
        out["all_gather_stacked"] = bool(torch.equal(
            stacked, torch.stack([x_of(r) for r in model_line])))
        xx = torch.cat([x_of(rank), x_of(rank)], 0).requires_grad_(True)
        z = C.psum_scatter(xx, "model", 0)            # [5, 7]
        (z * w[rank]).sum().backward()
        want = torch.cat([w[r] for r in model_line], 0)
        zs = None
        for r in model_line:
            zs = x_of(r) if zs is None else zs + x_of(r)
        out["psum_scatter"] = bool(torch.equal(z.detach(), zs))
        out["psum_scatter_bwd"] = bool(torch.equal(xx.grad, want))
        out["axis_index"] = (C.axis_index("data"), C.axis_index("model"),
                             C.axis_index(("data", "model")))
    sweep = make_sweep_mesh(2, device="cpu")
    coord = sweep.get_coordinate()
    out["sweep_mesh"] = (sweep.mesh_dim_names, tuple(sweep.shape),
                         None if coord is None else tuple(coord))
    return out


# ---------------------------------------------------------------------------
# the sharded training state and its checkpoints
# ---------------------------------------------------------------------------

def _shard_setup(arch: str, shape, seed: int = 0, sp: bool = False):
    """``(cfg, ctx, opt_cfg, replicated state)`` of a SHARD_CASES case
    (``sp``: a SHARD_SP_CASES case)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import MeshContext
    from repro_torch.training import AdamWConfig, init_train_state

    cfg = get_smoke_config(arch).with_(dtype="float32", remat=True)
    ctx = MeshContext(make_host_mesh(model=shape[1], device="cpu"),
                      ("data",), sp_matmuls=sp)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    return cfg, ctx, opt, init_train_state(
        cfg, opt, torch.Generator().manual_seed(seed))


def _blocks_at(pipe, step: int, ctx):
    """``(blocks, bound ctx)`` of the pipeline's batch ``step``."""
    from repro_torch.models.transformer import shard_batch

    return shard_batch({k: torch.from_numpy(v)
                        for k, v in pipe.batch_at(step).items()}, ctx)


def _state_leaves(state) -> Dict[str, torch.Tensor]:
    """``{"params/<n>" | "m/<n>" | "v/<n>": tensor}`` of a TrainState."""
    from repro_torch.training import param_tree

    out = {f"params/{n}": p.detach()
           for n, p in param_tree(state.params).items()}
    out.update({f"m/{n}": t for n, t in state.opt.m.items()})
    out.update({f"v/{n}": t for n, t in state.opt.v.items()})
    return out


def _blocks_vs(sharded, whole, ctx) -> Dict[str, float]:
    """Each leaf of a sharded state against this rank's block of the same
    leaf of a whole one: max |diff| over the whole leaf's largest
    |value| (0.0 where bit-equal)."""
    from repro_torch.models.layers import block_of
    from repro_torch.training import param_tree

    specs = {n: p.pspec for n, p in param_tree(sharded.params).items()}
    want, got = _state_leaves(whole), _state_leaves(sharded)
    out = {}
    for key, g in got.items():
        w = want[key]
        b = block_of(w, specs[key.split("/", 1)[1]], ctx)
        if g.shape != b.shape:
            out[key] = float("inf")
        elif torch.equal(g, b):
            out[key] = 0.0
        else:
            out[key] = float((g - b).abs().max()) / max(
                float(w.abs().max()), 1e-30)
    return out


def shard_case(rank: int, arch: str, shape) -> Dict:
    """The sharded state of ``arch`` on ``shape``: shard then gather back
    (the identity), the bytes it holds, SHARD_STEPS steps of the same
    step function on it and on the replicated state (losses, each block
    against the replicated state's), and the SSD scans' head counts."""
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import collectives as C
    from repro_torch.models.layers import leaf_split
    from repro_torch.training import (gather_train_state, make_train_step,
                                      param_tree, shard_train_state,
                                      state_bytes)

    cfg, ctx, opt, state = _shard_setup(arch, shape)
    sharded = shard_train_state(state, cfg, ctx)
    back = gather_train_state(sharded, ctx)
    identity = all(torch.equal(a, b) for a, b in zip(
        _state_leaves(back).values(), _state_leaves(state).values()))
    world = shape[0] * shape[1]
    whole_bytes, held = state_bytes(state), state_bytes(sharded)
    multi = [a for a in ctx.mesh_axes if C.axis_size(a, mesh=ctx.mesh) > 1]
    stay_whole = {}          # leaves not split over some axis: their bytes
    for n, p in param_tree(sharded.params).items():
        split = {a for axes in leaf_split(ctx, p.pspec, p.whole_shape)
                 if axes for a in axes}
        if any(a not in split for a in multi):
            stay_whole[n] = 3 * p.numel() * p.element_size()
    pipe = TokenPipeline(cfg, global_batch=SHARD_B, seq_len=SHARD_S, seed=1)
    batches = [_blocks_at(pipe, i, ctx) for i in range(SHARD_STEPS)]
    step = make_train_step(cfg, opt, batches[0][1])
    losses = {"replicated": [], "sharded": []}
    with _scanned_heads() as heads:
        for batch, _ in batches:
            state, m1 = step(state, batch)
            sharded, m2 = step(sharded, batch)
            losses["replicated"].append(float(m1["loss"]))
            losses["sharded"].append(float(m2["loss"]))
    return dict(identity=identity, whole_bytes=whole_bytes, held=held,
                stay_whole=stay_whole, world=world, losses=losses,
                blocks=_blocks_vs(sharded, state, ctx),
                steps=int(sharded.opt.step), scan_heads=sorted(set(heads)))


def shard_sp_case(rank: int, arch: str, shape) -> Dict:
    """A SHARD_SP_CASES case: SHARD_STEPS steps of the same step function
    on the sharded and the replicated state (losses, each block against
    the replicated state's), the dimensions each block parameter's plans
    all-gathered, and whether make_train_step refuses a grad_transform on
    the sharded state."""
    from repro_torch.data import TokenPipeline
    from repro_torch.training import (make_train_step, param_tree,
                                      shard_train_state)

    cfg, ctx, opt, state = _shard_setup(arch, shape, sp=True)
    sharded = shard_train_state(state, cfg, ctx)
    pipe = TokenPipeline(cfg, global_batch=SHARD_SP_B, seq_len=SHARD_SP_S,
                         seed=1)
    batches = [_blocks_at(pipe, i, ctx) for i in range(SHARD_STEPS)]
    ctx = batches[0][1]
    try:
        make_train_step(cfg, opt, ctx, grad_transform=dict)(sharded,
                                                            batches[0][0])
        refused = False
    except ValueError:
        refused = True
    step = make_train_step(cfg, opt, ctx)
    losses = {"replicated": [], "sharded": []}
    for batch, _ in batches:
        state, m1 = step(state, batch)
        sharded, m2 = step(sharded, batch)
        losses["replicated"].append(float(m1["loss"]))
        losses["sharded"].append(float(m2["loss"]))
    gathered = {n: sorted({d for plan in p.mesh_plans.values()
                           for _, d in plan.gather})
                for n, p in param_tree(sharded.params).items()
                if hasattr(p, "mesh_plans")}
    return dict(losses=losses, blocks=_blocks_vs(sharded, state, ctx),
                gathered=gathered, refused=refused)


def shard_sp_cases(rank: int, cases) -> Dict:
    """Every SHARD_SP_CASES case of this spawn's shape."""
    return {f"{a}_{s[0]}{s[1]}": shard_sp_case(rank, a, s) for a, s in cases}


def shard_cases(rank: int, cases, ckpt: str, shape) -> Dict:
    """Every SHARD_CASES case of this spawn's shape, then the checkpoint
    cases (:func:`checkpoint_case`)."""
    out = {f"{a}_{s[0]}{s[1]}": shard_case(rank, a, s) for a, s in cases}
    out["checkpoint"] = checkpoint_case(rank, ckpt, shape)
    return out


def checkpoint_case(rank: int, ckpt: str, shape) -> Dict:
    """Checkpoints of CKPT_ARCH's sharded state. At (2, 2): SHARD_STEPS
    steps, a blocking save with ``mesh=``/``pspecs=`` into
    ``ckpt/sharded`` and an async one through CheckpointManager into
    ``ckpt/managed``, each restored with ``mesh=``/``pspecs=`` into
    another sharded state and into a replicated one (which comes back
    sharded); rank 0 returns the whole leaves it saved. At every shape:
    the reference's checkpoint ``ckpt/reference`` (the port's leaves from
    seed 3, written by the reference's save_checkpoint) and, at (1, 4),
    the (2, 2) spawn's ``ckpt/sharded`` restored into this shape's
    sharded state, each block against the block of the one-device
    restore of the same checkpoint."""
    from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                        restore_checkpoint, save_checkpoint)
    from repro_torch.data import TokenPipeline
    import torch.distributed as dist
    from repro_torch.training import (gather_train_state, make_train_step,
                                      shard_train_state, train_state_pspecs)

    cfg, ctx, opt, state = _shard_setup(CKPT_ARCH, shape)
    pspecs = train_state_pspecs(cfg)
    mesh = ctx.mesh

    def fresh(seed, sharded=True):
        s = _shard_setup(CKPT_ARCH, shape, seed)[3]
        return shard_train_state(s, cfg, ctx) if sharded else s

    def restored_vs_one_device(path, step):
        whole = restore_checkpoint(path, step, fresh(7, sharded=False))
        out = {}
        for kind, like in (("sharded", fresh(8)),
                           ("replicated", fresh(9, sharded=False))):
            got = restore_checkpoint(path, step, like, mesh=mesh,
                                     pspecs=pspecs)
            errs = _blocks_vs(got, whole, ctx)
            out[kind] = max(errs.values())
            out[f"{kind}_step"] = int(got.opt.step)
        return out

    out = {"reference": restored_vs_one_device(f"{ckpt}/reference", 1)}
    if shape == (2, 2):
        sharded = shard_train_state(state, cfg, ctx)
        pipe = TokenPipeline(cfg, global_batch=SHARD_B, seq_len=SHARD_S,
                             seed=1)
        step = make_train_step(cfg, opt, _blocks_at(pipe, 0, ctx)[1])
        for i in range(SHARD_STEPS):
            sharded, _ = step(sharded, _blocks_at(pipe, i, ctx)[0])
        save_checkpoint(f"{ckpt}/sharded", CKPT_STEP, sharded, mesh=mesh,
                        pspecs=pspecs)
        mgr = CheckpointManager(f"{ckpt}/managed", every=1)
        mgr.maybe_save(CKPT_STEP, sharded, mesh=mesh, pspecs=pspecs)
        mgr.wait()
        dist.barrier()
        for name in ("sharded", "managed"):
            got = restore_checkpoint(f"{ckpt}/{name}", CKPT_STEP,
                                     fresh(5), mesh=mesh, pspecs=pspecs)
            out[f"{name}_bitequal"] = max(_blocks_vs(
                got, gather_train_state(sharded, ctx), ctx).values()) == 0
        step_, again = CheckpointManager(f"{ckpt}/managed") \
            .restore_latest(fresh(6), mesh=mesh, pspecs=pspecs)
        out["managed_latest"] = (step_, max(_blocks_vs(
            again, gather_train_state(sharded, ctx), ctx).values()) == 0)
        out["latest"] = latest_step(f"{ckpt}/sharded")
        whole = gather_train_state(sharded, ctx)
        if rank == 0:
            from repro_torch.checkpoint.checkpoint import _flatten

            out["whole"] = [t.detach().numpy().copy()
                            for t in _flatten(whole)[0]]
    if shape == (1, 4):
        out["from_22"] = restored_vs_one_device(f"{ckpt}/sharded",
                                                CKPT_STEP)
    return out
