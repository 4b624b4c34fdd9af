"""The port's device mesh against the reference's, on the CPU:
``repro_torch.launch.mesh``, ``MeshContext`` with the Megatron-SP
projections, the MoE's expert- and tensor-parallel modes, the
vocab-parallel embedding and the mesh-summed gradients.

The reference runs in one subprocess (tests/torch_mesh_reference.py) on a
4-device host platform with Auto axes (its own ``make_host_mesh`` builds
Explicit axes, on which its constraints raise under JAX 0.9). The port
runs in one spawn of 4 gloo ranks per mesh shape (tests/torch_mesh_ranks
.py), each rank doing every check of its shape: the smoke configs in
float32 at (data, model) = (4, 1), (2, 2) and (1, 4), with ``sp_matmuls``
off and on, each rank fed its ``shard_batch`` blocks, which are bit-equal
to the ``addressable_shards`` of the batch put on the reference's mesh
with its ``batch_pspecs`` (whole, at ``grad_accum = 2``, and a decode
step's tokens); a mesh call given the global batch raises. The final
hidden state gathered from the ranks' blocks within 1e-5 of the
reference's mesh forward; the loss within 1e-4 of it and every gradient
leaf within 1e-4 of the leaf's largest |value| against ``jax.grad`` of the
reference's ``loss_fn`` under the mesh (with ``sp_matmuls`` off: the
reference's SP gradient is the same function; over two microbatches for
mixtral with a capacity that drops) and against the port's own one-device
gradient with one microbatch a data rank (the mesh's MoE gives each data
rank's tokens their own capacity); every rank's summed gradients
bit-identical."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import torch_mesh_ranks as R  # noqa: E402
from torch_recorders import recorders_off  # noqa: E402,F401  (autouse)

SHAPES = sorted({c.shape for c in R.MODEL_CASES})
CASE_SP = [(c, sp) for c in R.MODEL_CASES for sp in c.sps]
IDS = [f"{c.name}-sp{int(sp)}" for c, sp in CASE_SP]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{case name: [rank 0's results, …]} from one spawn a mesh shape."""
    ref = R.run_reference(str(tmp_path_factory.mktemp("mesh_ref")),
                          "models")
    out = {}
    for shape in SHAPES:
        cases = [c for c in R.MODEL_CASES if c.shape == shape]
        tmp = tmp_path_factory.mktemp(f"ranks_{shape[0]}{shape[1]}")
        per_rank = R.spawn(R.model_cases, shape[0] * shape[1], str(tmp),
                           cases, ref)
        for c in cases:
            out[c.name] = [r[c.name] for r in per_rank]
    return out


@pytest.mark.parametrize("case,sp", CASE_SP, ids=IDS)
def test_forward_matches_the_reference_mesh(results, case, sp):
    d, m = case.shape
    cfg_d = {"yi_34b": 128, "mixtral_8x7b": 64, "smollm_360m": 96}
    want = (case.B // d if case.B % d == 0 else case.B,
            case.S // m if case.S % m == 0 else case.S, cfg_d[case.arch])
    for rank in results[case.name]:
        assert rank[sp]["local_shape"] == want
        assert rank[sp]["fwd"] <= R.FWD_TOL, rank[sp]["fwd"]


@pytest.mark.parametrize("case,sp", CASE_SP, ids=IDS)
def test_loss_and_gradients_match_jax_grad_on_the_mesh(results, case, sp):
    for rank in results[case.name]:
        r = rank[sp]
        np.testing.assert_allclose(r["loss"], r["ref_loss"],
                                   rtol=R.GRAD_TOL)
        bad = {n: e for n, e in r["vs_ref"].items() if e > R.GRAD_TOL}
        assert not bad, bad


@pytest.mark.parametrize("case,sp", CASE_SP, ids=IDS)
def test_gradients_match_the_ports_one_device_gradient(results, case, sp):
    for rank in results[case.name]:
        bad = {n: e for n, e in rank[sp]["vs_one"].items()
               if e > R.GRAD_TOL}
        assert not bad, bad


@pytest.mark.parametrize("case,sp", CASE_SP, ids=IDS)
def test_ranks_hold_the_same_gradients_and_counted_collectives(results,
                                                               case, sp):
    ranks = results[case.name]
    for rank in ranks[1:]:
        assert np.array_equal(rank[sp]["digest"], ranks[0][sp]["digest"])
    counts = ranks[0][sp]["counts"]
    assert counts["psum"]["calls"] > 0 and counts["psum"]["bytes"] > 0
    if case.shape[1] > 1:
        assert counts["all_gather"]["calls"] > 0
    if sp and case.shape[1] > 1:
        assert counts["psum_scatter"]["calls"] > 0


@pytest.mark.parametrize("case", R.MODEL_CASES,
                         ids=[c.name for c in R.MODEL_CASES])
def test_shard_batch_blocks_are_the_reference_s_shards(results, case):
    """Each rank's ``shard_batch`` blocks of the batch, of its two
    microbatches (the reference's row order) and of a decode step's tokens
    are its device's addressable shards on the reference's mesh; the
    global batch is refused."""
    for rank in results[case.name]:
        r = rank[case.sps[0]]
        for what in ("blocks", "accum_blocks", "decode_blocks"):
            assert r[what] and all(r[what].values()), (what, r[what])
        assert r["global_refused"]


def test_the_per_shard_capacity_drops_assignments(results):
    """mixtral_drops_22: T_local = 320 tokens route 640 assignments into
    capacity 80 per expert, half what one device gives the whole batch
    (640 tokens, capacity 160) — and the mesh still matches the
    reference's mesh gradient and the one-device gradient of one
    microbatch a data rank (above)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.layers import moe_capacity

    case = next(c for c in R.MODEL_CASES if c.name == "mixtral_drops_22")
    cfg = R.case_config(case, get_smoke_config(case.arch))
    T = case.B * case.S
    assert moe_capacity(T // case.shape[0], cfg) < moe_capacity(T, cfg) / 1.5
    # mixtral_accum_22: a data rank's microbatch is one row of 160 tokens
    case = next(c for c in R.MODEL_CASES if c.name == "mixtral_accum_22")
    local = T // (case.shape[0] * case.accum)
    assert local * cfg.top_k > 256 and \
        moe_capacity(local, cfg) < local * cfg.top_k / cfg.n_experts


ZOO = ("smollm_360m", "gemma2_27b", "command_r_35b", "yi_34b",
       "mixtral_8x7b", "qwen3_moe_235b", "mamba2_2p7b", "zamba2_2p7b",
       "hubert_xlarge", "internvl2_1b")


@pytest.mark.parametrize("arch", ZOO)
def test_param_pspecs_match_the_reference(arch):
    from repro.configs import get_config as jget
    from repro.models import transformer as JT
    from repro.training.trainer import train_state_pspecs as jtrain

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.training import train_state_pspecs

    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    for tp in (1, 16):
        jcfg, tcfg = jget(arch).with_(tp_shards=tp), get_config(arch).with_(
            tp_shards=tp)
        for stacked in (True, False):
            want = jax.tree_util.tree_map(tuple, JT.param_pspecs(
                jcfg, stacked), is_leaf=is_p)
            assert TT.param_pspecs(tcfg, stacked) == want
        jst, tst = jtrain(jcfg), train_state_pspecs(tcfg)
        assert tst.params == jax.tree_util.tree_map(tuple, jst.params,
                                                    is_leaf=is_p)
        assert tst.opt.step == tuple(jst.opt.step)
        assert tst.opt.m == tst.params and tst.opt.v == tst.params


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "zamba2_2p7b",
                                  "internvl2_1b"])
def test_leaf_pspecs_name_every_port_parameter(arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as TT

    cfg = get_smoke_config(arch)
    model = TT.init_params(cfg, torch.Generator().manual_seed(0))
    specs = TT.leaf_pspecs(model, cfg)
    params = dict(model.named_parameters())
    assert list(specs) == list(params)
    for name, spec in specs.items():
        assert len(spec) == params[name].ndim, (name, spec)
    if arch == "mixtral_8x7b":
        assert specs["layers.1.moe.w_gate"] == ("model", "data", None)
        assert specs["layers.0.attn.wo"] == ("model", None, "data")
    if arch == "zamba2_2p7b":
        assert specs["mamba.3.block.in_proj"] == ("data", "model")
        assert specs["shared.0.attn.wq"] == ("data", "model", None)
    assert specs["tok"] == ("model", "data")


def test_mesh_factories(tmp_path):
    """Outside a process group every factory raises; in a one-rank gloo
    group the host mesh is (1, 1), the reference's text for a degree that
    does not divide, the production mesh refuses the wrong world, the
    sweep mesh is 1-D."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as M

    with pytest.raises(RuntimeError, match="init_process_group"):
        M.make_host_mesh(device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        mesh = M.make_host_mesh(device="cpu")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        assert M.mesh_devices(mesh) == 1
        with pytest.raises(ValueError, match=r"cannot build a \(data=1//2, "
                           r"model=2\) mesh: the model-parallel degree must "
                           r"be a positive divisor of the 1 available"):
            M.make_host_mesh(model=2, device="cpu")
        with pytest.raises(ValueError, match="256 ranks"):
            M.make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="512 ranks"):
            M.make_production_mesh(multi_pod=True, device="cpu")
        sweep = M.make_sweep_mesh(5, device="cpu")
        assert sweep.mesh_dim_names == ("data",) and tuple(sweep.shape) == (1,)
        assert M.batch_axes(True) == ("pod", "data")
        assert M.batch_axes(False) == ("data",)
    finally:
        dist.destroy_process_group()
