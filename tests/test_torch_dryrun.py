"""The port's dry run against the reference's, on the CPU:
``repro_torch.launch.shapes``/``specs``/``dryrun`` and
``repro_torch.analysis.step_cost``.

In process: the cell plans, configs, input specs and spec trees equal to
the reference's; the small repairs the dry run needed (a fixed-size expert
count, the collectives' group cache, parameters drawn onto another
device) against the old paths; the kernels' cost functions against the
counts chip_smoke.py's bounds used before they moved beside the kernels.
The per-device ``dot_flops`` of smoke cells on a (2, 2) mesh: the
reference compiles them in one subprocess (tests/torch_dryrun_reference.py,
4 host devices, Auto axes), the port traces them on fake CPU tensors over
a fake 4-rank process group, where the plain versions run (the full S × S
attention blocks, as the reference's ``flash_attention_jnp`` computes
them), within 2 % with nothing subtracted: a rank's logits are its
vocabulary block and a Mamba layer's model rank computes its ``N/model``
B/C columns, as each device of the reference does. The CLI end to end
in a subprocess, and a multi-pod and a ``long_500k`` cell through
``run_cell`` in process (which destroys its fake process group in a
``finally``)."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import torch_dryrun_reference as DR  # noqa: E402
from torch_recorders import recorders_off  # noqa: E402,F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("yi_34b", "smollm_360m", "gemma2_27b", "command_r_35b",
         "hubert_xlarge", "zamba2_2p7b", "internvl2_1b", "qwen3_moe_235b",
         "mixtral_8x7b", "mamba2_2p7b")
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _runnable():
    from repro.launch.shapes import cell_plan
    return [(a, s) for a in ARCHS for s in SHAPE_NAMES if cell_plan(a, s)[0]]


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join(
                    [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """The reference's compiles and the port's CLI, started at once in two
    subprocesses: ``{"ref": (proc, path), "cli": (proc, out dir)}``."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = _env()
    ref_path = tmp / "ref_flops.json"
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dryrun_reference.py"),
         str(ref_path)], env=dict(
            env, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm_360m", "--shape", "prefill_32k", "--single-pod", "--out",
         str(tmp / "cli")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield {"ref": (ref, ref_path), "cli": (cli, tmp / "cli")}
    for p in (ref, cli):
        if p.poll() is None:
            p.kill()
        p.communicate()


# ---------------------------------------------------------------------------
# shapes, configs, input specs, spec trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_cell_plan_is_the_reference_s(arch, shape):
    from repro.launch.shapes import SHAPES as JS, cell_plan as jplan

    from repro_torch.launch.shapes import SHAPES, cell_plan

    assert cell_plan(arch, shape) == jplan(arch, shape)
    assert dataclasses.asdict(SHAPES[shape]) == dataclasses.asdict(
        JS[shape])


def test_all_cells_are_the_reference_s():
    from repro.launch.shapes import LONG_OK as JL, all_cells as jall

    from repro_torch.launch.shapes import LONG_OK, all_cells

    assert all_cells() == jall() and LONG_OK == JL
    assert [a for a, *_ in all_cells()][::4] == list(ARCHS)


@pytest.mark.parametrize("tp", [1, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_configs_are_the_reference_s(arch, tp):
    from repro.launch import specs as JS

    from repro_torch.launch import specs as TS

    assert TS.OPT_STATE_DTYPE == JS.OPT_STATE_DTYPE
    assert TS.TRAIN_PARAM_DTYPE == JS.TRAIN_PARAM_DTYPE
    for name in ("training_config", "serving_config"):
        assert dataclasses.asdict(getattr(TS, name)(arch, tp)) == \
            dataclasses.asdict(getattr(JS, name)(arch, tp)), name


def _same_spec(got: tuple, want) -> bool:
    """The port's spec tuple read as a ``PartitionSpec`` (which writes a
    one-axis tuple as the bare name) is the reference's."""
    from jax.sharding import PartitionSpec as P
    return P(*got) == want


def _same_struct(meta: torch.Tensor, sds) -> bool:
    return tuple(meta.shape) == tuple(sds.shape) and meta.device.type == \
        "meta" and str(meta.dtype).split(".")[1] == str(sds.dtype)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", _runnable())
def test_input_specs_are_the_reference_s(arch, shape, multi_pod):
    from repro.launch.specs import input_specs as jspecs

    from repro_torch.launch.specs import input_specs

    want, got = jspecs(arch, shape, multi_pod), input_specs(arch, shape,
                                                            multi_pod)
    assert set(got) == set(want)
    assert dataclasses.asdict(got["config"]) == dataclasses.asdict(
        want["config"])
    for key in ("batch", "cache"):
        if key not in want:
            continue
        w = want[key] if key == "batch" else want[key]._asdict()
        wsp = want[f"{key}_pspecs"]
        wsp = wsp if key == "batch" else wsp._asdict()
        assert set(got[key]) == set(w)
        for name, sds in w.items():
            assert _same_struct(got[key][name], sds), (key, name)
            assert _same_spec(got[f"{key}_pspecs"][name], wsp[name]), name
    if "token" in want:
        assert _same_struct(got["token"], want["token"])
        assert _same_spec(got["token_pspecs"], want["token_pspecs"])
    if "ring" in want:
        assert got["ring"] == want["ring"]


@pytest.mark.parametrize("arch", ARCHS)
def test_retarget_fsdp_is_the_reference_s(arch):
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config as jget
    from repro.models import transformer as JT
    from repro.training.trainer import train_state_pspecs as jtrain

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.training import train_state_pspecs

    is_p = lambda x: isinstance(x, P)  # noqa: E731
    axes = ("pod", "data")
    jcfg, tcfg = jget(arch, tp_shards=16), get_config(arch, tp_shards=16)
    want = jax.tree_util.tree_map(tuple, JT.retarget_fsdp(
        JT.param_pspecs(jcfg), axes), is_leaf=is_p)
    assert TT.retarget_fsdp(TT.param_pspecs(tcfg), axes) == want
    jst = jax.tree_util.tree_map(tuple, JT.retarget_fsdp(
        jtrain(jcfg), axes), is_leaf=is_p)
    tst = TT.retarget_fsdp(train_state_pspecs(tcfg), axes)
    assert tst.params == jst.params and tst.opt.step == jst.opt.step
    assert tst.opt.m == jst.opt.m and tst.opt.v == jst.opt.v
    assert any("data" in s for s in jax.tree_util.tree_leaves(
        TT.param_pspecs(tcfg), is_leaf=lambda x: isinstance(x, tuple)))
    assert TT.retarget_fsdp(TT.param_pspecs(tcfg), "data") == \
        TT.param_pspecs(tcfg)


# ---------------------------------------------------------------------------
# the small repairs, against the old paths
# ---------------------------------------------------------------------------

def _bincount_route(x, router, cfg, capacity):
    """``moe_route`` as it was, counting with ``torch.bincount``."""
    T = x.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = torch.bincount(se, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k) - starts[se]
    kept = pos < capacity
    slot = torch.where(kept, se * capacity + pos,
                       torch.full_like(pos, E * capacity))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k)
    return gate, idx, slot[inv].reshape(T, k), kept[inv].reshape(T, k)


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "qwen3_moe_235b"])
@pytest.mark.parametrize("tokens,cap", [(40, None), (40, 3), (6, None)])
def test_moe_route_counts_as_bincount_did(arch, tokens, cap):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as L

    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((tokens, cfg.d_model)
                                             ).astype(np.float32))
    router = torch.from_numpy(rng.standard_normal(
        (cfg.d_model, cfg.n_experts)).astype(np.float32))
    router[:, 1] = router[:, 0]           # exact ties between experts
    capacity = cap or L.moe_capacity(tokens, cfg)
    got = L.moe_route(x, router, cfg, capacity)
    for a, b in zip(got, _bincount_route(x, router, cfg, capacity)):
        assert torch.equal(a, b)


def test_reset_groups_makes_new_groups():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_host_mesh

    made = []
    try:
        for world in (4, 8):
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=world)
            mesh = make_host_mesh(model=2, device="cpu")
            group = C._group(mesh, ("data", "model"))
            assert dist.get_world_size(group) == world
            made.append(group)
            dist.destroy_process_group()
            C.reset_groups()
            assert not C._GROUPS
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        C.reset_groups()
    assert made[0] is not made[1]


@pytest.mark.parametrize("arch", ["smollm_360m", "mixtral_8x7b",
                                  "mamba2_2p7b", "zamba2_2p7b"])
def test_init_params_device_keeps_the_numbers(arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = get_smoke_config(arch)
    a = T.init_params(cfg, torch.Generator().manual_seed(3))
    b = T.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    meta = T.init_params(cfg, torch.Generator().manual_seed(3),
                         device="meta")
    for (n, p), (_, q), (_, r) in zip(a.named_parameters(),
                                      b.named_parameters(),
                                      meta.named_parameters()):
        assert torch.equal(p, q), n
        assert r.device.type == "meta" and r.shape == p.shape, n
    for hd, theta in ((32, 10_000.0), (128, 1e6)):
        # a fake tensor's table is made anew, a real one's once
        assert torch.equal(L._rope_table(hd, theta, "cpu"),
                           L._rope_freqs(hd, theta, torch.device("cpu")))


# ---------------------------------------------------------------------------
# the kernels' cost functions against chip_smoke.py's old counts
# ---------------------------------------------------------------------------

def _old_pairs(Sq, Skv, causal, window):
    q = np.arange(Sq)
    hi = np.minimum(Skv, q + 1) if causal else np.full(Sq, Skv)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(Sq, int)
    return int(np.maximum(hi - lo, 0).sum())


def test_kernel_costs_are_the_phases_counts():
    sys.path.insert(0, str(ROOT))
    import chip_smoke as c

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.gqa_decode import ops as gd
    from repro_torch.kernels.ssd_scan import ops as ss

    # B4 (phase 2's main case and its MoE/smoke shapes, 2 bytes an element)
    attn = [(c.SERVE_B, c.SERVE_PROMPT, c.SERVE_PROMPT, 15, 5, 64, True, 0)]
    attn += [(B, S, S, Hq, Hkv, hd, True, 0) for _, B, S, Hq, Hkv, hd in
             c.MOE_ATTN_SHAPES + c.SMOKE_ATTN_SHAPES]
    attn += [(1, 4500, 4500, 4, 2, 128, True, 4096),
             (2, 200, 333, 8, 2, 32, False, 0)]
    for B, Sq, Skv, Hq, Hkv, hd, causal, window in attn:
        pairs = _old_pairs(Sq, Skv, causal, window)
        cost = fa.flash_attention_cost(B, Sq, Skv, Hq, Hkv, hd, 2, causal,
                                       window)
        assert cost.flops == 4 * hd * B * Hq * pairs
        assert cost.bytes == 2 * (2 * B * Sq * Hq * hd + 2 * B * Skv * Hkv
                                  * hd) + 4 * B * Hq * Sq
        # B5/B6 (phase 11's _bwd_work, at bf16 and float32)
        for nb in (2, 4):
            q_side, kv_side = B * Sq * Hq * hd, B * Skv * Hkv * hd
            bwd = fa.flash_attention_bwd_cost(B, Sq, Skv, Hq, Hkv, hd, nb,
                                              causal, window)
            assert tuple(bwd["flash_attention_dq"]) == (
                6 * hd * B * Hq * pairs,
                nb * (3 * q_side + 2 * kv_side) + 8 * B * Hq * Sq)
            assert tuple(bwd["flash_attention_dkv"]) == (
                8 * hd * B * Hq * pairs,
                nb * (2 * q_side + 4 * kv_side) + 8 * B * Hq * Sq)
    # B7: phase 2's decode rows (every row's kv_len below the cache), and
    # phase 26's block of mixtral's ring (every slot valid)
    for B, Sc, Hkv, G, hd in [(c.SERVE_B, c.SERVE_SEQ, 5, 3, 64),
                              (c.SERVE_B, c.SERVE_SEQ, 32, 1, 80),
                              (2, 64, 2, 2, 16)]:
        lens = [c.SERVE_PROMPT + c.SERVE_STEPS // 2 if Sc > 64 else 18] * B
        slots = sum(min(n, Sc) for n in lens)
        assert gd.decode_slots(lens, Sc) == slots
        assert tuple(gd.gqa_decode_cost(B, Hkv, G, hd, 2, slots)) == (
            4 * hd * G * Hkv * slots,
            2 * (2 * B * Hkv * G * hd + 2 * slots * Hkv * hd) + 4 * B)
    B, Sc, Hkv, G, hd, n = 1, 4096, 8, 4, 128, 4
    b = Sc // n
    assert gd.decode_slots([8192 + 17], b, ring=True, slot0=b,
                           sc_total=Sc) == b
    assert tuple(gd.gqa_decode_cost(B, Hkv, G, hd, 2, b, True)) == (
        4 * hd * G * Hkv * b,
        2 * (2 * B * Hkv * G * hd + 2 * b * Hkv * hd) + 4 * B
        + 4 * B * Hkv * G)
    # B8 and its backward (phases 4 and 19)
    for B, L, H, P, N, chunk in [(2, 1024, 80, 64, 128, 256),
                                 (1, 4096, 20, 64, 128, 256),
                                 (2, 100, 4, 16, 16, 32),
                                 (4, 128, 8, 64, 64, 64)]:
        for with_init in (False, True):
            pairs = sum(q * (q + 1) // 2 for q in
                        (min(chunk, L - c0) for c0 in range(0, L, chunk)))
            n_bytes, ops = ss.ssd_scan_work(B, L, H, P, N, chunk, with_init)
            assert n_bytes == 4 * (2 * B * L * H * P + B * L * H + 2 * B * L
                                   * N + (2 if with_init else 1) * B * H * P
                                   * N)
            assert ops == {"chunked": 2 * B * (pairs * N + H * (
                pairs * P + 2 * L * P * N)),
                "sequential": 5 * B * H * L * P * N}
            assert c._ssd_work(B, L, H, P, N, chunk, with_init) == (
                n_bytes, min(ops.values()), min(ops, key=ops.get))
        for with_dfinal in (False, True):
            Lp = -(-L // chunk) * chunk
            nc = Lp // chunk
            pairs = nc * chunk * (chunk + 1) // 2
            cost = ss.ssd_scan_bwd_cost(B, L, H, P, N, chunk, with_dfinal)
            assert tuple(cost) == (
                2 * B * (3 * pairs * N + H * (2 * pairs * P
                                              + 4 * Lp * P * N)),
                4 * (3 * B * L * H * P + 2 * B * L * H + 4 * B * L * N
                     + B * nc * H * (P * N + 1)
                     + (2 if with_dfinal else 1) * B * H * P * N))


# ---------------------------------------------------------------------------
# dot FLOPs a device on a (2, 2) mesh, against XLA's compiled HLO
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_flops():
    """The port's traced dot FLOPs of every FLOP_CASES case."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.analysis import trace_step
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.launch.specs import cell_step

    out = {}
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(DR.MESH)))
    try:
        mesh = make_host_mesh(model=DR.MESH[1], device="cpu")
        for arch, kind, B, S in DR.FLOP_CASES:
            cfg = DR.case_config(get_smoke_config, arch, kind)
            with FakeTensorMode(allow_non_fake_inputs=True):
                step, args, _ = cell_step(cfg, ShapeCell("x", kind, S, B),
                                          mesh, False, device="cpu")
                cost, _ = trace_step(step, *args)
            assert not cost.kernels      # CPU tensors: the plain versions
            out[DR.case_key(arch, kind, B, S)] = (cost.dot_flops, cfg)
    finally:
        dist.destroy_process_group()
        C.reset_groups()
    return out


@pytest.mark.parametrize("arch,kind", [("smollm_360m", "train"),
                                       ("mamba2_2p7b", "prefill")])
def test_trace_step_counts_flop_counter_mode_s_flops(arch, kind):
    """``trace_step`` applies ``FlopCounterMode``'s formulas in its own
    mode: the same dot FLOPs as ``FlopCounterMode`` around it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis import trace_step
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)

    cfg = DR.case_config(get_smoke_config, arch, kind)
    with FakeTensorMode(allow_non_fake_inputs=True):
        gen = torch.Generator().manual_seed(0)
        tokens = torch.zeros((2, 64), dtype=torch.int32)
        if kind == "train":
            opt = AdamWConfig()
            fn = make_train_step(cfg, opt)
            args = (init_train_state(cfg, opt, gen),
                    {"tokens": tokens, "targets": tokens,
                     "mask": torch.ones((2, 64))})
        else:
            cache, ring = T.init_cache(cfg, 2, 64, "cpu")
            fn = lambda m, t, c: T.prefill(m, cfg, t, c, ring)  # noqa: E731
            args = (T.init_params(cfg, gen), tokens, cache)
        with FlopCounterMode(display=False) as counter:
            cost, _ = trace_step(fn, *args)
    assert cost.dot_flops == counter.get_total_flops() > 0
    assert cost.flops > cost.dot_flops and cost.hbm_bytes > 0


@pytest.mark.parametrize("case", DR.FLOP_CASES,
                         ids=[DR.case_key(*c) for c in DR.FLOP_CASES])
def test_dot_flops_a_device_are_the_reference_s(case, background,
                                                port_flops):
    proc, path = background["ref"]
    if proc.poll() is None:
        proc.wait(timeout=600)
    assert proc.returncode == 0, proc.stdout.read()[-4000:]
    ref = json.loads(path.read_text())[DR.case_key(*case)]
    got, _ = port_flops[DR.case_key(*case)]
    assert ref > 0
    assert abs(got - ref) <= 0.02 * ref, (got, ref)


# ---------------------------------------------------------------------------
# the CLI and whole cells at the production meshes
# ---------------------------------------------------------------------------

def test_dryrun_cli_single_cell(background):
    proc, out = background["cli"]
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-2000:]
    assert "[ok]" in stdout
    rec = json.loads((out / "smollm_360m__prefill_32k__pod16x16.json"
                      ).read_text())
    assert rec["status"] == "ok" and rec["kind"] == "prefill"
    assert rec["devices"] == 256
    assert rec["corrected"]["flops"] > 0
    assert rec["memory"]["per_device_hbm_bytes"] > 0
    assert rec["kernels"]["flash_attention"]["calls"] == 32
    assert rec["wire"]["all-reduce"]["calls"] == 0
    assert rec["collectives"]["all-to-all"]["count"] == \
        rec["wire"]["all-to-all"]["calls"] > 0
    assert {"lower_s", "compile_s", "cost_analysis", "hlo_lines"}.isdisjoint(
        rec)


def _cell(arch, shape, multi_pod, tmp_path):
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.dryrun import run_cell
    import torch.distributed as dist

    rec = run_cell(arch, shape, multi_pod, out=tmp_path)
    assert not dist.is_initialized() and not C._GROUPS
    name = f"{arch}__{shape}__{rec['mesh']}.json"
    assert json.loads((tmp_path / name).read_text()) == rec
    return rec


def test_multi_pod_cell_spreads_fsdp_over_pod_and_data(tmp_path):
    rec = _cell("smollm_360m", "decode_32k", True, tmp_path)
    assert rec["status"] == "ok" and rec["mesh"] == "pod2x16x16"
    assert rec["devices"] == 512 and rec["kind"] == "decode"
    assert rec["kernels"]["gqa_decode"]["calls"] == 32
    # every FSDP gather spans pod × data: 32 blocks of each weight
    ag = rec["wire"]["all-gather"]
    assert ag["result_bytes"] > 0 and ag["calls"] > 0
    from repro_torch.launch.specs import input_specs
    spec = input_specs("smollm_360m", "decode_32k", True)
    assert spec["cache_pspecs"]["kv_k"][1] == ("pod", "data")


def test_long_500k_cell_lays_the_kv_slots_over_the_batch_axes(tmp_path):
    rec = _cell("mixtral_8x7b", "long_500k", False, tmp_path)
    assert rec["status"] == "ok" and rec["kind"] == "decode"
    # B7 over each rank's block of the 4,096-slot ring: 256 slots a rank,
    # every slot valid, combined over the batch axes
    b7 = rec["kernels"]["gqa_decode"]
    assert b7["calls"] == 32
    from repro_torch.configs import get_config
    cfg = get_config("mixtral_8x7b", tp_shards=16)
    G, hd = cfg.gqa.n_q_pad // cfg.gqa.n_kv_pad, cfg.head_dim
    hkv = cfg.gqa.n_kv_pad // 16
    assert b7["flops"] == 32 * 4 * hd * G * hkv * (4096 // 16)
    skip = __import__("repro_torch.launch.dryrun", fromlist=["run_cell"]
                      ).run_cell("yi_34b", "long_500k", False,
                                 out=tmp_path)
    assert skip["status"] == "skip" and "500k" in skip["skip_reason"]
