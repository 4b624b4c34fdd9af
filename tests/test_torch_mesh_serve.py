"""Serving on the port's device mesh against the reference's, on the CPU:
``prefill(ctx=)`` and greedy ``decode_step(ctx=)`` with the caches kept as
each rank's blocks (``init_cache(ctx=)``, ``gather_cache``,
``shard_cache``), B7's block variant (a rank's block of cache slots with
the whole cache's valid range and its logsumexp, combined over the
ranks), and the bf16 psum summed in float32 as XLA sums it.

As in tests/test_torch_mesh.py: the reference in one subprocess on a
4-device host platform with Auto axes (``jax.set_mesh``; it writes the
parameters and prompts first, and the port's ranks start from them while
it computes), the port in one spawn of 4 gloo ranks a mesh shape. The
smoke configs in float32, 4 rows of 16-token prompts and 3 greedy decode
steps (SERVE_CASES: smollm, yi, gemma2, mixtral in ep and tp mode with a
ring that wraps, mamba2, zamba2, internvl2 with its patches, hubert's
mesh prefill; (4, 1), (2, 2), (1, 4); an SP prefill; zamba2 stored as
blocks; mixtral and zamba2 at batch 1 with the KV slots over data = 4),
each rank fed its ``shard_batch`` blocks and giving its rows ×
``V_pad/model`` block of the logits: each block within 1e-5 of the
reference's shard on that device under ``build_cell``'s
``out_shardings``, the logits gathered whole (``gather_logits``) within
1e-5 of the reference's largest |logit|, every cache field gathered whole
within 1e-5 of its largest |value| (the Mamba conv cache kept as each
model rank's ``[x | B | C]`` channels), the greedy tokens exact (``argmax``
of the gathered logits, fed back as blocks); the global prompt is
refused. ``cache_pspecs`` equals the reference's ``_cache_struct`` specs for
the zoo. The port's bf16 ``psum``/``psum_scatter`` are bit-equal to XLA's
under ``shard_map`` on seeded ``[4, 65536]`` rows, where a running bf16
sum is not. B7's plain version over 1-4 blocks of the cache, combined, is
the whole cache's within 1e-6, and its split plan rehearses the kernel's
block range; the kernel's block variant is held on the card (JAX is
imported by the tests that read the reference, so these run where only
the port is installed)."""
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from test_torch_decode_split import H100_SMS, _split_plan
from torch_recorders import recorders_off  # noqa: F401  (autouse)

from repro_torch.kernels import gqa_decode as gd

SHAPES = ((4, 1), (2, 2), (1, 4))
IDS = [c.name for c in R.SERVE_CASES]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The reference's ``serve`` part in the background; once it has
    written the inputs, one spawn of 4 ranks a mesh shape (the (1, 4)
    spawn also runs the psum witness); then the reference's results."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("mesh_serve")
    ref = R.Reference(str(tmp), "serve")
    try:
        inputs = ref.wait_for(ref.path + ".inputs.npz")
        out = {}
        for shape in SHAPES:
            work = [("serve", "serve_cases",
                     ([c for c in R.SERVE_CASES if c.shape == shape],
                      inputs))]
            if shape == (1, 4):
                work.append(("psum", "psum_case", (inputs,)))
            out[shape] = R.spawn(R.jobs, 4, str(tmp / f"ranks_{shape[0]}"
                                                f"{shape[1]}"), *work)
        out["ref"] = dict(np.load(ref.result()))
    finally:
        ref.close()
    return out


def _rel(got, want) -> float:
    """max |got - want| over want's largest |value| (0 for empty ones)."""
    if not want.size:
        return 0.0
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    return err / scale if scale else err


def _check_run(run, ref, key, cfg, case):
    """One rank's prefill and decode against the reference's."""
    bad = {}
    for tag in ("prefill", "last"):
        for field in ("logits", "kv_k", "kv_v", "conv", "ssm"):
            want = ref[f"{key}/{tag}/{field}"]
            got = run[tag][field]
            if got.shape != want.shape:
                bad[f"{tag}/{field}"] = (got.shape, want.shape)
            elif _rel(got, want) > R.SERVE_TOL:
                bad[f"{tag}/{field}"] = _rel(got, want)
    for i in range(R.SERVE_STEPS):
        e = _rel(run[f"step{i}"], ref[f"{key}/step{i}/logits"])
        if e > R.SERVE_TOL:
            bad[f"step{i}"] = e
    assert not bad, bad
    np.testing.assert_array_equal(run["tokens"], ref[f"{key}/tokens"])


@pytest.mark.parametrize("case", R.SERVE_CASES, ids=IDS)
def test_serving_matches_the_reference_mesh(results, case):
    from repro_torch.configs import get_smoke_config

    cfg = R.serve_config(case, get_smoke_config(case.arch))
    ref = results["ref"]
    ranks = [r["serve"][case.name] for r in results[case.shape]]
    if cfg.encoder_only:
        for r in ranks:
            assert _rel(r["logits"], ref[f"{case.name}/logits"]) \
                <= R.SERVE_TOL
        return
    d, m = case.shape
    for r in ranks:
        _check_run(r, ref, case.name, cfg, case)
        assert r["refused"]          # a one-device cache is refused
        np.testing.assert_array_equal(r["tokens"], ranks[0]["tokens"])
        kv = r["block_shapes"]["kv_k"]
        rows = case.B // d if case.B % d == 0 else case.B
        assert kv[1] == rows
        if cfg.n_heads:
            heads = cfg.gqa.n_kv_pad
            assert kv[3] == (heads // m if cfg.gqa.n_q_pad % m == 0
                             and heads % m == 0 else heads)
        if cfg.family in ("ssm", "hybrid"):
            split = cfg.ssm_heads % m == 0
            N = cfg.ssm_state
            assert r["block_shapes"]["ssm"][2] == (
                cfg.ssm_heads // m if split else cfg.ssm_heads)
            # a rank's [x | B | C] channels: 1/model of d_inner + 2N
            assert r["block_shapes"]["conv"][3] == (
                cfg.d_inner // m + 2 * (N // m if N % m == 0 else N)
                if split else cfg.d_inner + 2 * N)
        if case.shard_seq:
            # the KV slots over data = 4: B7 runs on each rank's block
            Sc = ref[f"{case.name}/last/kv_k"].shape[2]
            assert r["seq_block_shapes"]["kv_k"][2] == Sc // d
            assert r["seq_init_same"]   # init_cache(shard_seq=True) too
            assert {(s, t) for s, _, t in r["b7"]} == {(Sc // d, Sc)}
        elif cfg.n_heads:
            assert all(s0 == 0 and t is None for _, s0, t in r["b7"])
        # a decode step's exchanges: the out-projections' psums (and the
        # blocks' outputs, all-gathered) where the mesh splits heads or
        # slots; none where nothing is split
        counts = r["step_counts"]
        split = m > 1 and (cfg.n_heads and cfg.gqa.n_kv_pad % m == 0
                           or cfg.family in ("ssm", "hybrid")
                           and cfg.ssm_heads % m == 0 or cfg.n_experts)
        if split or case.shard_seq:
            assert sum(c["calls"] for c in counts.values()) > 0


@pytest.mark.parametrize("case", R.SERVE_CASES, ids=IDS)
def test_logits_blocks_are_the_reference_s_shards(results, case):
    """Each rank's block of the prefill's and every decode step's logits
    (an encoder's stream block) has the shape of the reference's shard on
    that rank's device and its values within SERVE_TOL; a mesh prefill
    given the global prompt raises."""
    from repro_torch.configs import get_smoke_config

    cfg = R.serve_config(case, get_smoke_config(case.arch))
    ref = results["ref"]
    key = case.name
    d, m = case.shape
    # the 16-token prompt splits over any model axis; a batch of 1 over
    # (4, 1) is its own block
    blocked = m > 1 or case.B % d == 0
    for r in [r["serve"][key] for r in results[case.shape]]:
        if cfg.encoder_only:
            pairs = [(r["block"], ref[f"{key}/encode/shard/{r['coord']}"])]
        else:
            assert r["global_refused"] == blocked
            pairs = [(r["prefill_block"],
                      ref[f"{key}/prefill/shard/{r['coord']}"])] + [
                (r[f"step{i}_block"], ref[f"{key}/step{i}/shard/"
                                          f"{r['coord']}"])
                for i in range(R.SERVE_STEPS)]
        for got, want in pairs:
            assert got.shape == want.shape
            assert _rel(got, want) <= R.SERVE_TOL


def test_blocks_serve_as_the_replicated_model(results):
    """zamba2 stored as each rank's blocks (shard_module) serves the
    replicated model's logits and caches within 1e-6 of their largest
    |value| (a materialized weight block is contiguous where the
    replicated weight's slice is a strided view, so a product may round
    apart), and its tokens exactly."""
    (case,) = [c for c in R.SERVE_CASES if c.blocks]
    for r in results[case.shape]:
        run = r["serve"][case.name]
        for tag in ("prefill", "last"):
            for field, want in run[tag].items():
                assert _rel(run["blocks"][tag][field], want) <= 1e-6
        np.testing.assert_array_equal(run["blocks"]["tokens"],
                                      run["tokens"])


def test_bf16_psum_is_xla_s(results):
    """The port's bf16 psum and psum_scatter over 4 ranks equal XLA's
    under shard_map bit for bit (float32 sums rounded once); the old
    running bf16 sum does not."""
    ref = results["ref"]
    want, scatter = ref["psum/sum"], ref["psum/scatter"]
    n = R.PSUM_N // 4
    for i, r in enumerate(results[(1, 4)]):
        p = r["psum"]
        np.testing.assert_array_equal(p["psum"], want)
        np.testing.assert_array_equal(p["scatter"],
                                      scatter[i * n:(i + 1) * n])
        same = float(np.mean(p["running"] == want))
        assert same < 0.9, same


ZOO = ("smollm_360m", "gemma2_27b", "yi_34b", "command_r_35b",
       "mixtral_8x7b", "qwen3_moe_235b", "mamba2_2p7b", "zamba2_2p7b",
       "hubert_xlarge", "internvl2_1b")


@pytest.mark.parametrize("shard_seq", [False, True])
@pytest.mark.parametrize("arch", ZOO)
def test_cache_pspecs_are_the_reference_s(arch, shard_seq):
    """cache_pspecs against the specs the reference's dry run lowers its
    caches with (specs._cache_struct), over ("data",) and ("pod",
    "data")."""
    pytest.importorskip("jax")
    from repro.configs import get_config as jget
    from repro.launch.specs import _cache_struct

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    for baxes in (("data",), ("pod", "data")):
        _, want, _ = _cache_struct(jget(arch), 1, 64, baxes, shard_seq)
        got = T.cache_pspecs(get_config(arch), baxes, shard_seq)
        for field, spec in got.items():
            # PartitionSpec writes one axis of a tuple as its name
            one = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                        for e in spec)
            assert one == tuple(getattr(want, field)), (field, spec)


# ---------------------------------------------------------------------------
# B7 over a block of cache slots: the plain version and the split plan
# ---------------------------------------------------------------------------

#: (B, Hkv, G, hd, Sc, kv_len, window, ring, softcap, blocks): a ring that
#: wraps across blocks, a window, a softcap, a prompt shorter than one
#: block (empty blocks), kv_len 0, one block
BLOCK_CASES = [
    (2, 2, 2, 32, 64, (100, 70), 0, True, 0.0, 4),
    (2, 2, 3, 64, 96, (90, 40), 20, False, 0.0, 3),
    (1, 1, 4, 16, 64, (33,), 0, False, 30.0, 2),
    (3, 2, 1, 32, 64, (5, 0, 64), 0, False, 0.0, 4),
    (2, 1, 8, 64, 48, (48, 17), 0, False, 0.0, 1),
    (1, 2, 2, 16, 8, (19,), 0, True, 50.0, 4),
]


def _block_inputs(case, seed=7):
    B, Hkv, G, hd, Sc, lens = case[:6]
    rng = np.random.default_rng(seed)

    def randn(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    return (randn((B, Hkv * G, hd)), randn((B, Sc, Hkv, hd)),
            randn((B, Sc, Hkv, hd)), torch.tensor(lens, dtype=torch.int32))


@pytest.mark.parametrize("case", BLOCK_CASES, ids=str)
def test_plain_b7_blocks_combine_to_the_whole_cache(case):
    B, Hkv, G, hd, Sc, lens, window, ring, softcap, n = case
    q, kc, vc, kv_len = _block_inputs(case)
    kw = dict(window=window, ring=ring, softcap=softcap)
    whole = gd.gqa_decode_ref(q, kc, vc, kv_len, **kw)
    assert torch.equal(whole, gd.gqa_decode_ref(q, kc, vc, kv_len,
                                                slot0=0, sc_total=Sc, **kw))
    b = Sc // n
    outs, lses = [], []
    for r in range(n):
        o, lse = gd.gqa_decode_ref(q, kc[:, r * b:(r + 1) * b],
                                   vc[:, r * b:(r + 1) * b], kv_len,
                                   slot0=r * b, sc_total=Sc,
                                   return_lse=True, **kw)
        outs.append(o)
        lses.append(lse)
        mask = gd.decode_valid_mask(kv_len, Sc, window=window,
                                    ring=ring)[:, r * b:(r + 1) * b]
        empty = ~mask.any(-1)
        assert (lse[empty] == gd.ref.NEG).all()
        assert not o[empty].any()
    got = gd.combine_blocks(torch.stack(outs), torch.stack(lses))
    assert float((got - whole).abs().max()) <= 1e-6
    # the whole cache's lse is its blocks' logsumexp
    _, lse_whole = gd.gqa_decode_ref(q, kc, vc, kv_len, return_lse=True,
                                     **kw)
    has = lse_whole > 0.5 * gd.ref.NEG
    comb = torch.logsumexp(torch.stack(lses), 0)
    assert float((comb[has] - lse_whole[has]).abs().max()) <= 1e-5


def test_combine_blocks_drops_a_lost_block():
    """A control: the combine without one non-empty block is far from the
    whole cache's output."""
    case = BLOCK_CASES[0]
    B, Hkv, G, hd, Sc, lens, window, ring, softcap, n = case
    q, kc, vc, kv_len = _block_inputs(case)
    whole = gd.gqa_decode_ref(q, kc, vc, kv_len, ring=ring)
    b = Sc // n
    parts = [gd.gqa_decode_ref(q, kc[:, r * b:(r + 1) * b],
                               vc[:, r * b:(r + 1) * b], kv_len, ring=ring,
                               slot0=r * b, sc_total=Sc, return_lse=True)
             for r in range(n)]
    outs = torch.stack([o for o, _ in parts])
    lses = torch.stack([lse for _, lse in parts])
    lses[1] = gd.ref.NEG
    assert float((gd.combine_blocks(outs, lses) - whole).abs().max()) > 1e-2


@pytest.mark.parametrize("case", BLOCK_CASES, ids=str)
def test_split_plan_over_a_block_of_slots(case):
    """The kernel's plan (split-KV over a cluster) on each block, with the
    valid range computed on the whole cache and intersected with the
    block, equals the plain version on the block, output and lse."""
    B, Hkv, G, hd, Sc, lens, window, ring, softcap, n = case
    q, kc, vc, kv_len = _block_inputs(case)
    kw = dict(window=window, ring=ring, softcap=softcap)
    b = Sc // n
    for r in range(n):
        blk = (kc[:, r * b:(r + 1) * b], vc[:, r * b:(r + 1) * b])
        splits = gd.decode_splits(B, Hkv, b, H100_SMS)
        o, lse = _split_plan(q, *blk, kv_len, splits=splits, slot0=r * b,
                             sc_total=Sc, return_lse=True, **kw)
        po, plse = gd.gqa_decode_ref(q, *blk, kv_len, slot0=r * b,
                                     sc_total=Sc, return_lse=True, **kw)
        assert float((o - po).abs().max()) <= 2e-6
        assert torch.equal(lse == gd.ref.NEG, plse == gd.ref.NEG)
        has = plse > 0.5 * gd.ref.NEG
        assert float((lse[has] - plse[has]).abs().max()) <= 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BLOCK_CASES, ids=str)
def test_b7_block_kernel_matches_plain(cuda, dtype, case):
    """B7's block variant on the card against its plain version: output
    within B7's gate, lse within 1e-5, one launch a call."""
    from test_torch_flash_bwd import BF16_ULPS, _bf16_ulps

    B, Hkv, G, hd, Sc, lens, window, ring, softcap, n = case
    q, kc, vc, kv_len = (t.to(cuda) for t in _block_inputs(case))
    if dtype == "bfloat16":
        q, kc, vc = (t.to(torch.bfloat16) for t in (q, kc, vc))
    kw = dict(window=window, ring=ring, softcap=softcap)
    b = Sc // n
    for r in range(n):
        blk = (kc[:, r * b:(r + 1) * b].contiguous(),
               vc[:, r * b:(r + 1) * b].contiguous())
        n0 = gd.LAUNCHES["gqa_decode"]
        o, lse = gd.gqa_decode_cuda(q, *blk, kv_len, slot0=r * b,
                                    sc_total=Sc, return_lse=True, **kw)
        po, plse = gd.gqa_decode_ref(q, *blk, kv_len, slot0=r * b,
                                     sc_total=Sc, return_lse=True, **kw)
        torch.cuda.synchronize()
        assert gd.LAUNCHES["gqa_decode"] == n0 + 1
        if dtype == "float32":
            assert float((o - po).abs().max()) <= 2e-5
        else:
            assert _bf16_ulps(o, po) <= BF16_ULPS
        assert torch.equal(lse == gd.ref.NEG, plse == gd.ref.NEG)
        has = plse > 0.5 * gd.ref.NEG
        assert float((lse[has] - plse[has]).abs().max()) <= 1e-5
