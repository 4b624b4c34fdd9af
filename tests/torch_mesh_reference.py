"""The reference's side of the port's mesh tests: run in one subprocess
with ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and
``JAX_PLATFORMS=cpu``, it computes on ``jax.make_mesh(shape, ("data",
"model"), axis_types=(AxisType.Auto,) * 2)`` (the reference's
``make_host_mesh`` builds Explicit axes, on which its sharding constraints
raise under JAX 0.9) and writes one ``.npz``:

    python tests/torch_mesh_reference.py OUT.npz models|train|tp|gap|serve

``models``: for each of torch_mesh_ranks.MODEL_CASES its initial
parameters, for each ``sp_matmuls`` the forward's final hidden under
``MeshContext(mesh, ("data",), sp_matmuls=sp)``, and the loss and
``jax.grad`` of ``loss_fn`` under the first of them (the reference's SP
and baseline gradients are one function; a compile is most of the cost),
over the case's ``accum`` microbatches as its ``make_train_step`` slices
them; and each device's addressable shard of the batch put on the mesh
with its ``batch_pspecs`` (``specs._batch_struct``), of each of its
microbatches at ``grad_accum = 2`` (concatenated in order), and of a
decode step's tokens (``input_specs``'s ``token_pspecs``), keyed by the
device's mesh coordinate.
``train``: the same for SSM_CASES and FRONTEND_CASES, and for
TRAIN_CASES the initial
parameters given to ``run_training`` and its losses with ``mesh=``.
``tp``: the same as ``models`` for TP_CASES (the Mamba2 and Zamba2
stacks with their heads split over the model axis). ``gap``: GAP_ARCH's
bfloat16 loss on one device and on GAP_SHAPES's meshes
(tests/torch_mesh_bf16_gap.py). ``serve``: first, for each of
SERVE_CASES, its parameters and prompt into ``OUT.npz.inputs.npz`` (so
that the port's ranks can start), then ``prefill`` and SERVE_STEPS greedy
``decode_step`` calls under ``MeshContext`` (jitted under ``jax.set_mesh``;
a ``shard_seq`` case's decode with the cache's ``in_shardings`` from
``specs._cache_struct(..., shard_seq_cache=True)``): the logits, the
greedy tokens and the cache after the prefill and after the last step, and
each device's shard of every step's logits under ``build_cell``'s
``out_shardings``; an encoder-only model's ``forward`` and ``logits_fn``
(the dry run's ``encode`` cell) and each device's shard of them."""
import os
import sys

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=4")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_ranks as R  # noqa: E402


def _mesh(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _params(cfg, seed: int = 0):
    """Parameters in the reference's tree: Normal(0, 0.02) from NumPy in
    every leaf (``init_params``'s shapes; run eagerly it takes seconds a
    model on the CPU)."""
    from repro.models import transformer as T

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: T.init_params(cfg, jax.random.PRNGKey(0)))
    return jax.tree_util.tree_map(
        lambda s: jax.numpy.asarray(
            (rng.standard_normal(s.shape) * 0.02).astype(s.dtype)), shapes)


def _shards(mesh, x, spec):
    """``{"<data index><model index>": shard}``: each device's addressable
    shard of ``x`` put on ``mesh`` with ``spec`` (a dimension that does
    not divide its axes whole, where ``device_put`` refuses it and the
    port keeps it whole)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def n(entry):
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        return int(np.prod([mesh.shape[a] for a in names]))

    spec = P(*(e if size % n(e) == 0 else None
               for e, size in zip(tuple(spec), x.shape)))
    arr = jax.device_put(x, NamedSharding(mesh, spec))
    by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return {f"{i}{j}": by_device[dev]
            for (i, j), dev in np.ndenumerate(mesh.devices)}


def batch_blocks(case, cfg, batch, out):
    """The devices' shards of ``batch`` under the reference's
    ``batch_pspecs`` at ``<case>/blocks/<coordinate>/``: whole (``a1/``),
    each of two microbatches of rows ``[i · B/2, (i+1) · B/2)``
    concatenated in order (``a2/``), and a decode step's tokens
    (``decode/``)."""
    from jax.sharding import PartitionSpec as P

    from repro.launch.shapes import ShapeCell
    from repro.launch.specs import _batch_struct

    mesh = _mesh(case.shape)
    _, specs = _batch_struct(cfg, ShapeCell("x", "train", case.S, case.B),
                             ("data",), with_targets=True)
    half = case.B // 2
    for k, v in batch.items():
        whole = _shards(mesh, v, specs[k])
        micro = [_shards(mesh, v[i * half:(i + 1) * half], specs[k])
                 for i in range(2)]
        for c, block in whole.items():
            out[f"{case.name}/blocks/{c}/a1/{k}"] = block
            out[f"{case.name}/blocks/{c}/a2/{k}"] = np.concatenate(
                [m[c] for m in micro], 0)
    if "tokens" in batch:
        for c, block in _shards(mesh, batch["tokens"][:, 0],
                                P(("data",))).items():
            out[f"{case.name}/blocks/{c}/decode/tokens"] = block


def _accumulated(cfg, ctx, params, batch, accum: int):
    """The loss and gradients of ``make_train_step``'s ``grad_accum``:
    ``value_and_grad`` of ``loss_fn`` on each microbatch of global rows
    ``[i · B/accum, (i+1) · B/accum)``, summed and divided."""
    from repro.models import transformer as T

    fn = jax.jit(jax.value_and_grad(lambda p, b: T.loss_fn(p, cfg, b, ctx)))
    per = next(iter(batch.values())).shape[0] // accum
    loss, grads = 0.0, None
    for i in range(accum):
        l, g = fn(params, {k: v[i * per:(i + 1) * per]
                           for k, v in batch.items()})
        loss = loss + l
        grads = g if grads is None else jax.tree_util.tree_map(
            jax.numpy.add, grads, g)
    return loss / accum, jax.tree_util.tree_map(lambda t: t / accum, grads)


def model_case(case, out):
    from repro.configs import get_smoke_config
    from repro.data import TokenPipeline
    from repro.models import transformer as T
    from repro.models.layers import MeshContext

    cfg = R.case_config(case, get_smoke_config(case.arch))
    params = _params(cfg)
    out.update(R.flatten(params, f"{case.name}/params/"))
    batch = {k: jax.numpy.asarray(v) for k, v in TokenPipeline(
        cfg, global_batch=case.B, seq_len=case.S, seed=1).batch_at(0).items()}
    batch_blocks(case, cfg, batch, out)
    for sp in case.sps:
        ctx = MeshContext(_mesh(case.shape), ("data",), sp_matmuls=sp)
        key = f"{case.name}/sp{int(sp)}"
        if sp != case.sps[0]:
            out[f"{key}/x"] = np.asarray(jax.jit(
                lambda p, b: T.forward(p, cfg, b, ctx))(params, batch))
            continue

        def loss_and_x(p, b):
            # loss_fn's body, the final hidden kept
            x = T.forward(p, cfg, b, ctx)
            return T.softmax_xent(p, cfg, x, b["targets"],
                                  b["mask"].astype(jax.numpy.float32),
                                  ctx), x

        (loss, x), grads = jax.jit(jax.value_and_grad(
            loss_and_x, has_aux=True))(params, batch)
        if case.accum > 1:
            loss, grads = _accumulated(cfg, ctx, params, batch, case.accum)
        out[f"{key}/x"] = np.asarray(x)
        out[f"{case.name}/loss"] = np.asarray(loss)
        out.update(R.flatten(grads, f"{case.name}/grads/"))


def train_case(arch, shape, compression, out):
    """``run_training(mesh=..., compression=...)`` from :func:`_params`
    (its initializer replaced, as the port's ranks replace theirs)."""
    import repro.training as RT
    from repro.configs import get_smoke_config
    from repro.launch.train import run_training

    params = _params(get_smoke_config(arch).with_(remat=True),
                     R.TRAIN_KW["seed"])
    out.update(R.flatten(params, f"train/{arch}/params/"))
    orig = RT.init_train_state
    RT.init_train_state = lambda cfg, opt_cfg, key: RT.TrainState(
        params, RT.adamw_init(params, opt_cfg))
    try:
        run = run_training(arch=arch, mesh=_mesh(shape), verbose=False,
                           compression=compression, **R.TRAIN_KW)
    finally:
        RT.init_train_state = orig
    out[f"train/{R.train_key(arch, shape, compression)}"] = np.asarray(
        run["losses"])


def gap_case(out):
    """GAP_ARCH's smoke config in its bfloat16 compute dtype, as phase 25
    of chip_smoke.py runs mixtral on the card: ``loss_fn`` on one device
    and on each GAP_SHAPES Auto mesh with ``sp_matmuls``, from
    :func:`_params`."""
    from repro.configs import get_smoke_config
    from repro.data import TokenPipeline
    from repro.models import transformer as T
    from repro.models.layers import MeshContext

    cfg = get_smoke_config(R.GAP_ARCH).with_(remat=True,
                                               **dict(R.GAP_OVER))
    params = _params(cfg)
    out.update(R.flatten(params, "gap/params/"))
    batch = {k: jax.numpy.asarray(v) for k, v in TokenPipeline(
        cfg, global_batch=R.GAP_B, seq_len=R.GAP_S, seed=1).batch_at(0)
        .items()}
    out["gap/one"] = np.asarray(jax.jit(
        lambda p, b: T.loss_fn(p, cfg, b))(params, batch))
    for shape in R.GAP_SHAPES:
        ctx = MeshContext(_mesh(shape), ("data",), sp_matmuls=True)
        out[f"gap/{shape[0]}{shape[1]}"] = np.asarray(jax.jit(
            lambda p, b: T.loss_fn(p, cfg, b, ctx))(params, batch))


def serve_inputs(path: str) -> None:
    """Every SERVE_CASES case's parameters (seed 0) and prompt, written
    atomically to ``path``."""
    from repro.configs import get_smoke_config

    out = {}
    for case in R.SERVE_CASES:
        cfg = R.serve_config(case, get_smoke_config(case.arch))
        out.update(R.flatten(_params(cfg), f"{case.name}/params/"))
        out.update({f"{case.name}/input/{k}": v
                    for k, v in R.serve_inputs(case, cfg).items()})
    rng = np.random.default_rng(3)
    out["psum/x"] = np.asarray(jax.numpy.asarray(
        rng.standard_normal((4, R.PSUM_N)), jax.numpy.bfloat16
    ).astype(jax.numpy.float32))
    np.savez(path + ".tmp.npz", **out)
    os.replace(path + ".tmp.npz", path)


def psum_witness(inputs, out):
    """XLA's bf16 ``psum`` and ``psum_scatter`` of the four rows of
    ``psum/x`` under ``shard_map`` over a 4-device model axis."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    x = jax.numpy.asarray(inputs["psum/x"], jax.numpy.bfloat16)
    mesh = _mesh((1, 4))
    total = shard_map(lambda r: jax.lax.psum(r[0], "model"), mesh=mesh,
                      in_specs=P("model", None), out_specs=P(),
                      check_rep=False)(x)
    scatter = shard_map(lambda r: jax.lax.psum_scatter(
        r[0], "model", scatter_dimension=0, tiled=True), mesh=mesh,
        in_specs=P("model", None), out_specs=P("model"),
        check_rep=False)(x)
    out["psum/sum"] = np.asarray(total.astype(jax.numpy.float32))
    out["psum/scatter"] = np.asarray(scatter.astype(jax.numpy.float32))


def serve_case(case, inputs, out):
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_smoke_config
    from repro.launch.specs import _cache_struct, _sh
    from repro.models import transformer as T
    from repro.models.layers import MeshContext

    cfg = R.serve_config(case, get_smoke_config(case.arch))
    params = jax.tree_util.tree_map(
        jax.numpy.asarray, R.unflatten(inputs, f"{case.name}/params/"))
    batch = {k[len(f"{case.name}/input/"):]: jax.numpy.asarray(v)
             for k, v in inputs.items()
             if k.startswith(f"{case.name}/input/")}
    mesh = _mesh(case.shape)
    ctx = MeshContext(mesh, ("data",), sp_matmuls=case.sp)
    key = case.name
    d, m = case.shape
    # build_cell's out_shardings of the logits (a size that does not
    # divide its axis whole, as the port keeps it)
    logits_spec = P("data" if case.B % d == 0 else None,
                    "model" if cfg.vocab_pad % m == 0 else None)

    def shards(tag, logits, spec=logits_spec):
        for c, block in _shards(mesh, logits, spec).items():
            out[f"{key}/{tag}/shard/{c}"] = block

    with jax.set_mesh(mesh):
        if cfg.encoder_only:
            logits = jax.jit(lambda p, b: T.logits_fn(
                p, cfg, T.forward(p, cfg, b, ctx), ctx))(params, batch)
            out[f"{key}/logits"] = np.asarray(logits)
            shards("encode", logits, P("data", "model", None))
            return
        max_seq = R.serve_max_seq(case, cfg)
        cache, ring = T.init_cache(cfg, case.B, max_seq)
        logits, cache = jax.jit(lambda p, b, c: T.prefill(
            p, cfg, b, c, ring, ctx))(params, batch, cache)

        def keep(tag, logits, cache):
            out[f"{key}/{tag}/logits"] = np.asarray(logits)
            for f in ("kv_k", "kv_v", "conv", "ssm"):
                out[f"{key}/{tag}/{f}"] = np.asarray(getattr(cache, f))

        keep("prefill", logits, cache)
        shards("prefill", logits)
        if case.shard_seq:
            _, cp, _ = _cache_struct(cfg, case.B, max_seq, ("data",),
                                     shard_seq_cache=True)
            cache = jax.device_put(cache, _sh(mesh, cp))
            step = jax.jit(lambda p, t, c: T.decode_step(p, cfg, t, c, ring,
                                                         ctx),
                           in_shardings=(None, None, _sh(mesh, cp)))
        else:
            step = jax.jit(lambda p, t, c: T.decode_step(p, cfg, t, c, ring,
                                                         ctx))
        toks = [np.asarray(logits).argmax(-1).astype(np.int32)]
        for i in range(R.SERVE_STEPS):
            logits, cache = step(params, jax.numpy.asarray(toks[-1]), cache)
            out[f"{key}/step{i}/logits"] = np.asarray(logits)
            shards(f"step{i}", logits)
            toks.append(np.asarray(logits).argmax(-1).astype(np.int32))
        keep("last", logits, cache)
        out[f"{key}/tokens"] = np.stack(toks)


def main(path: str, part: str) -> None:
    out = {}
    if part == "serve":
        serve_inputs(path + ".inputs.npz")
        inputs = dict(np.load(path + ".inputs.npz"))
        psum_witness(inputs, out)
        for case in R.SERVE_CASES:
            serve_case(case, inputs, out)
    elif part == "gap":
        gap_case(out)
    elif part in ("models", "tp"):
        for case in R.MODEL_CASES if part == "models" else R.TP_CASES:
            model_case(case, out)
    else:
        for case in R.SSM_CASES + R.FRONTEND_CASES:
            model_case(case, out)
        for arch, shape, compression in R.TRAIN_CASES:
            train_case(arch, shape, compression, out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
