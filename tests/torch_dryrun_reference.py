"""The reference's side of the dry run's FLOP parity test: run in one
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
and ``JAX_PLATFORMS=cpu``, it lowers and compiles each of FLOP_CASES on
``jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) *
2)`` as ``repro.launch.specs.build_cell`` does a production cell (the
reference's ``make_production_mesh`` builds Explicit axes, on which its
sharding constraints raise under JAX 0.9), and writes each case's
per-device ``analyze_hlo(compiled.as_text())["dot_flops"]`` to one JSON
file:

    python tests/torch_dryrun_reference.py OUT.json

The cases are the smoke configs of one family each (dense, MoE, SSM) at
``tp_shards=2``, with the production cells' dtypes, at a sequence of one
1,024-position attention chunk. Importing this module sets nothing up:
the port's side reads FLOP_CASES and :func:`case_config` from it.
"""
import json
import os
import sys

#: (arch, kind, global batch, sequence)
FLOP_CASES = [(arch, kind, 2, 1024)
              for arch in ("smollm_360m", "mixtral_8x7b", "mamba2_2p7b")
              for kind in ("train", "prefill", "decode")]
MESH = (2, 2)


def case_config(get_smoke_config, arch: str, kind: str):
    """The smoke config with the production cells' settings
    (``specs.training_config`` / ``serving_config`` at ``tp_shards`` =
    the model axis)."""
    if kind == "train":
        return get_smoke_config(arch).with_(
            tp_shards=MESH[1], param_dtype="float32", dtype="bfloat16",
            remat=True)
    return get_smoke_config(arch).with_(
        tp_shards=MESH[1], param_dtype="bfloat16", dtype="bfloat16",
        remat=False)


def case_key(arch: str, kind: str, B: int, S: int) -> str:
    return f"{arch}/{kind}/{B}x{S}"


def dot_flops(arch: str, kind: str, B: int, S: int) -> float:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, PartitionSpec as P

    from repro.analysis.hlo_cost import analyze_hlo
    from repro.configs import get_smoke_config
    from repro.launch.shapes import ShapeCell
    from repro.launch.specs import _batch_struct, _cache_struct, _sh
    from repro.models import transformer as T
    from repro.models.layers import MeshContext
    from repro.training import (AdamWConfig, init_train_state,
                                make_train_step, train_state_pspecs)

    mesh = jax.make_mesh(MESH, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ctx = MeshContext(mesh, ("data",))
    cfg = case_config(get_smoke_config, arch, kind)
    baxes = ("data",)
    with jax.set_mesh(mesh):
        if kind == "train":
            opt_cfg = AdamWConfig()
            state = jax.eval_shape(lambda: init_train_state(
                cfg, opt_cfg, jax.random.PRNGKey(0)))
            state_sp = train_state_pspecs(cfg)
            bst, bsp = _batch_struct(cfg, ShapeCell("x", kind, S, B), baxes,
                                     with_targets=True)
            fn = jax.jit(make_train_step(cfg, opt_cfg, ctx),
                         in_shardings=(_sh(mesh, state_sp), _sh(mesh, bsp)),
                         out_shardings=(_sh(mesh, state_sp), None),
                         donate_argnums=(0,))
            args = (state, bst)
        else:
            params = jax.eval_shape(
                lambda: T.init_params(cfg, jax.random.PRNGKey(0)))
            psp = T.param_pspecs(cfg)
            shard_seq = kind == "decode" and B == 1
            cs, cp, ring = _cache_struct(cfg, B, S, baxes,
                                         shard_seq_cache=shard_seq)
            if kind == "prefill":
                bst, bsp = _batch_struct(cfg, ShapeCell("x", kind, S, B),
                                         baxes, with_targets=False)
                fn = jax.jit(
                    lambda p, b, c: T.prefill(p, cfg, b, c, ring, ctx),
                    in_shardings=(_sh(mesh, psp), _sh(mesh, bsp),
                                  _sh(mesh, cp)),
                    out_shardings=(_sh(mesh, P(baxes, "model")),
                                   _sh(mesh, cp)),
                    donate_argnums=(2,))
                args = (params, bst, cs)
            else:
                tok = jax.ShapeDtypeStruct((B,), jnp.int32)
                fn = jax.jit(
                    lambda p, t, c: T.decode_step(p, cfg, t, c, ring, ctx),
                    in_shardings=(_sh(mesh, psp), _sh(mesh, P(baxes)),
                                  _sh(mesh, cp)),
                    out_shardings=(_sh(mesh, P(baxes, "model")),
                                   _sh(mesh, cp)),
                    donate_argnums=(2,))
                args = (params, tok, cs)
        hlo = fn.lower(*args).compile().as_text()
    return float(analyze_hlo(hlo)["dot_flops"])


def main(path: str) -> None:
    out = {case_key(*c): dot_flops(*c) for c in FLOP_CASES}
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=4")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main(sys.argv[1])
