"""Per-rank argument bytes of the dry run's production cells, the port's
against the reference's: the shared body of tests/test_torch_dryrun_bytes.py
(``pod16x16``, every arch and kind) and tests/test_torch_dryrun_multipod.py
(``pod2x16x16``, one arch per family).

The reference's side needs no compile: ``jax.eval_shape`` of its state or
parameters, its batch and cache structs (``repro.launch.specs``), each
leaf split by its spec as GSPMD splits an array over a mesh, evenly with
the block rounded up. The port's side is the bytes of the distinct
storages of ``specs.build_cell``'s fake arguments (the dry run's
``argument_size_in_bytes`` without tracing the step) over a fake process
group of the mesh's size.

The two must be equal once :func:`listed` has taken out what the test
works out here, leaf by leaf, and nothing else:

* ``kept``: the leaves with a dimension that does not divide its axes,
  which ``layers.leaf_split`` keeps whole (the reference pads it): their
  bytes by each side's rule (none at ``pod16x16``);
* ``pos``: the reference's ``Cache.pos``, a ``[B]`` int32 array, which
  the port keeps as a host int.

The inputs (``shard_batch``'s blocks) and the conv cache (each rank's
``[x | B | C]`` channels, ``CacheLayout.conv``) are held to the
reference's split like every other leaf.
"""
import functools

import numpy as np

MESH_SIZES = {"pod": 2, "data": 16, "model": 16}
#: one arch of each family: dense, moe, ssm, hybrid, audio, vlm
FAMILY_ARCHS = ("smollm_360m", "mixtral_8x7b", "mamba2_2p7b",
                "zamba2_2p7b", "hubert_xlarge", "internvl2_1b")


def cells(archs=None):
    from repro.configs import ARCH_IDS
    from repro.launch.shapes import SHAPES, cell_plan

    return [(a, s) for a in (archs or ARCH_IDS) for s in SHAPES
            if cell_plan(a, s)[0]]


def _n(entry, multi_pod: bool) -> int:
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    if not multi_pod:
        assert "pod" not in names
    return int(np.prod([MESH_SIZES[a] for a in names]))


def _gspmd(shape, spec, multi_pod) -> int:
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return int(np.prod([-(-d // _n(e, multi_pod))
                        for d, e in zip(shape, spec)]))


def _port_rule(shape, spec, multi_pod) -> int:
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return int(np.prod([d // n if n > 1 and d % n == 0 else d
                        for d, n in ((d, _n(e, multi_pod))
                                     for d, e in zip(shape, spec))]))


def _kept(shape, spec, multi_pod) -> bool:
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return any(n > 1 and d % n for d, n in
               ((d, _n(e, multi_pod)) for d, e in zip(shape, spec)))


@functools.lru_cache(maxsize=None)
def _reference_leaves(arch: str, shape: str, multi_pod: bool):
    """``[(group, name, shape, itemsize, spec)]`` of the reference's cell
    arguments; ``group`` is ``state``, ``conv``, ``pos`` or ``inputs``
    (``conv`` and ``inputs`` are split as ``state`` is; the groups name
    where a leaf comes from)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.launch import specs as JS
    from repro.launch.shapes import SHAPES
    from repro.models import transformer as JT
    from repro.training import AdamWConfig, init_train_state
    from repro.training import train_state_pspecs

    cell = SHAPES[shape]
    baxes = ("pod", "data") if multi_pod else ("data",)

    def fsdp(tree):
        return JT.retarget_fsdp(tree, baxes) if multi_pod else tree

    out = []

    def add(group, struct, specs, prefix):
        flat, _ = jax.tree_util.tree_flatten_with_path(struct)
        sflat = jax.tree_util.tree_flatten(
            specs, is_leaf=lambda x: isinstance(x, P))[0]
        assert len(flat) == len(sflat)
        for (path, s), sp in zip(flat, sflat):
            name = prefix + jax.tree_util.keystr(path)
            g = group
            if group == "cache":
                field = name.split(".")[-1]
                g = {"conv": "conv", "pos": "pos"}.get(field, "state")
            out.append((g, name, tuple(s.shape), s.dtype.itemsize,
                        tuple(sp)))

    spec = JS.input_specs(arch, shape, multi_pod)
    cfg = spec["config"]
    if cell.kind == "train":
        opt = AdamWConfig(state_dtype=JS.OPT_STATE_DTYPE.get(arch,
                                                             "float32"))
        state = jax.eval_shape(lambda: init_train_state(
            cfg, opt, jax.random.PRNGKey(0)))
        add("state", state, fsdp(train_state_pspecs(cfg)), "state")
    else:
        params = jax.eval_shape(lambda: JT.init_params(
            cfg, jax.random.PRNGKey(0)))
        add("state", params, fsdp(JT.param_pspecs(cfg)), "params")
    if "batch" in spec:
        add("inputs", spec["batch"], spec["batch_pspecs"], "batch")
    if "token" in spec:
        add("inputs", spec["token"], spec["token_pspecs"], "token")
    if "cache" in spec:
        add("cache", spec["cache"], spec["cache_pspecs"], "cache")
    return out, cfg


def listed(arch: str, shape: str, multi_pod: bool):
    """``(reference bytes, expected port bytes, {term: (reference, port)})``
    a rank; the terms are the module docstring's, ``kept`` itemized by
    leaf."""
    leaves, cfg = _reference_leaves(arch, shape, multi_pod)
    ref = port = 0
    terms = {}
    for group, name, shape_, size, spec in leaves:
        r = _gspmd(shape_, spec, multi_pod) * size
        ref += r
        if group == "pos":
            terms["pos"] = (r, 0)
            continue
        if group == "conv":
            p = _conv_bytes(cfg, shape_, spec, multi_pod) * size
        else:
            p = _port_rule(shape_, spec, multi_pod) * size
        port += p
        if p != r:
            terms[f"kept {name}"] = (r, p)
    return ref, port, terms


def _conv_bytes(cfg, shape, spec, multi_pod: bool) -> int:
    """Elements of a rank's conv cache block in the port: its rows, and of
    each channel group ``[x | B | C]`` its ``1/model`` where the SSM heads
    (for ``x``) and ``N`` (for ``B``/``C``) divide the model axis, the
    whole group elsewhere; every channel where the heads do not divide
    (``layers.mamba_channels``)."""
    L_, B, w, ch = shape
    rows = _port_rule((B,), spec[1:2], multi_pod)
    m = MESH_SIZES["model"]
    din, N = cfg.d_inner, cfg.ssm_state
    if ch and cfg.ssm_heads % m == 0:
        ch = din // m + 2 * (N // m if N % m == 0 else N)
    return L_ * rows * w * ch


def port_bytes(arch: str, shape: str, mesh, multi_pod: bool) -> int:
    """The bytes of the distinct storages of ``build_cell``'s fake
    arguments on this rank of ``mesh``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import tensors_of
    from repro_torch.launch.specs import build_cell

    with FakeTensorMode(allow_non_fake_inputs=True):
        _, args, _ = build_cell(arch, shape, mesh, multi_pod, device="meta")
        storages = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                    for t in tensors_of(args)}
    return sum(storages.values())


class FakeWorld:
    """A fake process group and the production mesh over it, made again
    when a test asks for the other mesh; :meth:`close` destroys it."""

    def __init__(self):
        self.multi_pod = None
        self.mesh = None

    def get(self, multi_pod: bool):
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore

        from repro_torch.launch.mesh import make_production_mesh

        if self.multi_pod is not multi_pod:
            self.close()
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=512 if multi_pod else 256)
            self.mesh = make_production_mesh(multi_pod=multi_pod,
                                             device="cuda")
            self.multi_pod = multi_pod
        return self.mesh

    def close(self):
        import torch.distributed as dist

        from repro_torch.distributed import collectives as C

        if dist.is_initialized():
            dist.destroy_process_group()
        C.reset_groups()
        self.multi_pod = self.mesh = None


def check(arch: str, shape: str, multi_pod: bool, world: FakeWorld):
    ref, want, terms = listed(arch, shape, multi_pod)
    got = port_bytes(arch, shape, world.get(multi_pod), multi_pod)
    assert got == want, (got, want, ref, terms)
    # the listed terms explain the whole difference, and each is named
    assert want - ref == sum(p - r for r, p in terms.values())
    return ref, got, terms
