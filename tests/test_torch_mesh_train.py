"""Training on the port's device mesh against the reference's, on the CPU:
the Mamba2 and Zamba2 stacks (their heads split over the model axis) and
the audio and vision frontends under a mesh context, the training state
stored as each rank's blocks (``shard_train_state``) and its checkpoints
(``restore_checkpoint(mesh=, pspecs=)``), ``run_training(mesh=)``
with one checkpoint writer and every rank resuming, and
``compressed_psum`` with the autograd collectives under it.

As in tests/test_torch_mesh.py: the reference in one subprocess on a
4-device host platform with Auto axes, the port in one spawn of 4 gloo
ranks per mesh shape. mamba2 and zamba2 (smoke configs, float32, 8 SSM
heads) at (data, model) = (4, 1), (2, 2) and (1, 4), a 6-head mamba2 at
(1, 4) (the heads do not divide: the whole block on each model rank),
hubert and internvl2 at (2, 2), each rank fed its ``shard_batch`` blocks
(bit-equal to the reference's ``addressable_shards`` of the batch under
its ``batch_pspecs``: frames, patches, tokens, targets, mask; at
``grad_accum = 2`` too): the gathered final hidden within 1e-5 of the
reference's, the loss and every gradient leaf within 1e-4 (of the leaf's
largest |value|) of ``jax.grad`` under the mesh and of the port's
one-device gradient, and each rank's SSD scans on ``H/model`` heads (each
model rank computing its ``N/model`` columns of ``B``/``C``, gathered
before the scan).
The sharded state of smollm, mixtral (ep), mamba2 and zamba2 at the three
shapes: shard then gather is the identity, each rank holds the
replicated bytes over the world plus the leaves that stay whole, and
after three steps every block is bit-equal to the same block of the
replicated state's. A sharded state's checkpoint restores bit-equal at
its own shape and at another, into the one-device port and into the
reference's ``restore_checkpoint``; the reference's checkpoint of the
port's leaves restores into a sharded state. ``run_training(mesh=...,
steps=3)`` of mixtral at
(4, 1) and (2, 2) and smollm at (2, 2) with topk error-feedback
compression (on the mesh-summed gradients), both packages
from the same parameters in their default bfloat16 compute: the first loss
within 1e-4, the others within 2e-3 (tests/test_integration.py's step
tolerances), every rank's parameters bit-identical after it."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch_mesh_ranks as R  # noqa: E402
from torch_recorders import recorders_off  # noqa: E402,F401  (autouse)

CASE_SP = [(c, sp) for c in R.SSM_CASES + R.TP_CASES + R.FRONTEND_CASES
           for sp in c.sps]
IDS = [f"{c.name}-sp{int(sp)}" for c, sp in CASE_SP]
SHARD_IDS = [f"{a}_{s[0]}{s[1]}" for a, s in R.SHARD_CASES]


def _reference_checkpoint(path):
    """The port's whole training state of R.CKPT_ARCH from seed 3,
    written by the reference's save_checkpoint as a list of leaves (the
    port's flatten order)."""
    import torch

    from repro.checkpoint import save_checkpoint as jsave
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.configs import get_smoke_config
    from repro_torch.training import AdamWConfig, init_train_state

    cfg = get_smoke_config(R.CKPT_ARCH).with_(dtype="float32", remat=True)
    state = init_train_state(cfg, AdamWConfig(),
                             torch.Generator().manual_seed(3))
    for t in state.opt.m.values():      # moments that are not zeros
        t.normal_(generator=torch.Generator().manual_seed(4))
    jsave(path, 1, [t.detach().numpy() for t in _flatten(state)[0]])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """One spawn of 4 ranks a mesh shape, each running the model cases,
    run_training cases and sharded-state cases of its shape; (2, 2) also
    the checkpoint resume and the compressed psum, and writes the
    sharded checkpoint that (1, 4) restores."""
    ref = R.run_reference(str(tmp_path_factory.mktemp("mesh_ref")), "train")
    tp = R.run_reference(str(tmp_path_factory.mktemp("mesh_tp")), "tp")
    shared = tmp_path_factory.mktemp("sharded_ckpt")
    _reference_checkpoint(str(shared / "reference"))
    out = {}
    for shape in ((4, 1), (2, 2), (1, 4)):
        work = []
        train = [c for c in R.TRAIN_CASES if c[1] == shape]
        if train:
            work.append(("train", "train_cases", (train, ref, str(
                tmp_path_factory.mktemp(f"ckpt_{shape[0]}{shape[1]}")))))
        models = [c for c in R.SSM_CASES + R.FRONTEND_CASES
                  if c.shape == shape]
        if models:
            work.append(("models", "model_cases", (models, ref)))
        work.append(("tp", "model_cases",
                     ([c for c in R.TP_CASES if c.shape == shape], tp)))
        work.append(("shard", "shard_cases", (
            [c for c in R.SHARD_CASES if c[1] == shape], str(shared),
            shape)))
        sp_cases = [c for c in R.SHARD_SP_CASES if c[1] == shape]
        if sp_cases:
            work.append(("shard_sp", "shard_sp_cases", (sp_cases,)))
        if shape == (2, 2):
            work.append(("psum", "compressed_psum_case", ()))
        tmp = tmp_path_factory.mktemp(f"train_ranks_{shape[0]}{shape[1]}")
        out[shape] = R.spawn(R.jobs, 4, str(tmp), *work)
    out["ckpt"] = shared
    return out


@pytest.mark.parametrize("case,sp", CASE_SP, ids=IDS)
def test_ssm_and_frontends_match_the_reference_mesh(results, case, sp):
    part = "tp" if case in R.TP_CASES else "models"
    ranks = [r[part][case.name][sp] for r in results[case.shape]]
    d, m = case.shape
    for r in ranks:
        assert r["local_shape"][:2] == (case.B // d, case.S // m)
        assert r["fwd"] <= R.FWD_TOL, r["fwd"]
        np.testing.assert_allclose(r["loss"], r["ref_loss"],
                                   rtol=R.GRAD_TOL)
        bad = {n: e for n, e in r["vs_ref"].items() if e > R.GRAD_TOL}
        bad.update({f"one-device {n}": e for n, e in r["vs_one"].items()
                    if e > R.GRAD_TOL})
        assert not bad, bad
        assert np.array_equal(r["digest"], ranks[0]["digest"])


@pytest.mark.parametrize("case", sorted({c for c, _ in CASE_SP}),
                         ids=lambda c: c.name)
def test_ssm_and_frontend_inputs_are_the_reference_s_blocks(results, case):
    """Each rank's ``shard_batch`` blocks (frames, patches, tokens,
    targets, mask; whole and at ``grad_accum = 2``; a decode step's
    tokens) are its device's addressable shards on the reference's mesh;
    the global inputs are refused."""
    part = "tp" if case in R.TP_CASES else "models"
    for rank in results[case.shape]:
        r = rank[part][case.name][case.sps[0]]
        for what in ("blocks", "accum_blocks"):
            assert r[what] and all(r[what].values()), (what, r[what])
        assert all(r["decode_blocks"].values()), r["decode_blocks"]
        assert r["global_refused"]


@pytest.mark.parametrize("arch,shape,compression", R.TRAIN_CASES,
                         ids=[R.train_key(*c) for c in R.TRAIN_CASES])
def test_run_training_on_the_mesh_matches_the_reference(results, arch,
                                                        shape, compression):
    name = R.train_key(arch, shape, compression)
    ranks = [r["train"][name] for r in results[shape]]
    for r in ranks:
        losses, want = np.asarray(r["losses"]), r["want"]
        assert losses.shape == want.shape == (R.TRAIN_KW["steps"],)
        np.testing.assert_allclose(losses[0], want[0],
                                   rtol=R.FIRST_STEP_TOL)
        np.testing.assert_allclose(losses, want, rtol=R.STEP_TOL)
        assert np.array_equal(r["digest"], ranks[0]["digest"])
        assert list(r["losses"]) == list(ranks[0]["losses"])


def test_one_rank_writes_checkpoints_and_every_rank_resumes(results):
    ranks = [r["train"]["resume"] for r in results[(2, 2)]]
    for r in ranks:
        assert r["written"] == ranks[0]["written"]
        assert r["start_step"] == R.TRAIN_KW["steps"]
        assert len(r["losses"]) == R.TRAIN_KW["steps"] + 1
        assert r["losses"] == ranks[0]["losses"]
    assert any("3" in w for w in ranks[0]["written"])


@pytest.mark.parametrize("axis", ["data", "model", "('data', 'model')"])
def test_compressed_psum_is_the_sum_of_int8_rounds(results, axis):
    for r in results[(2, 2)]:
        assert r["psum"][axis] == dict(int8=True, none=True)


def test_collectives_transpose_as_jax_does(results):
    for rank, r in enumerate(results[(2, 2)]):
        p = r["psum"]
        assert p["all_gather_bwd"] and p["all_gather_stacked"] \
            and p["psum_scatter"] and p["psum_scatter_bwd"]
        assert p["axis_index"] == (rank // 2, rank % 2, rank)
        assert p["sweep_mesh"] == (("data",), (2,),
                                   (rank,) if rank < 2 else None)


@pytest.mark.parametrize("case", [c for c in R.SSM_CASES + R.TP_CASES],
                         ids=[c.name for c in R.SSM_CASES + R.TP_CASES])
def test_each_model_rank_scans_its_heads(results, case):
    """B8 and the SSD backward run on H/model heads where the heads divide
    the model axis (no rank scans all H), on all H where they do not."""
    from repro_torch.configs import get_smoke_config

    H = R.case_config(case, get_smoke_config(case.arch)).ssm_heads
    m = case.shape[1]
    want = H // m if H % m == 0 else H
    part = "tp" if case in R.TP_CASES else "models"
    for r in results[case.shape]:
        for sp in case.sps:
            assert r[part][case.name][sp]["scan_heads"] == [want]
    if case.name == "mamba2_h6_14":
        assert H % m


def _shard(results, arch, shape):
    return [r["shard"][f"{arch}_{shape[0]}{shape[1]}"]
            for r in results[shape]]


@pytest.mark.parametrize("arch,shape", R.SHARD_CASES, ids=SHARD_IDS)
def test_shard_then_gather_is_the_identity(results, arch, shape):
    for r in _shard(results, arch, shape):
        assert r["identity"]


@pytest.mark.parametrize("arch,shape", R.SHARD_CASES, ids=SHARD_IDS)
def test_each_rank_holds_its_share_of_the_state(results, arch, shape):
    """A rank's parameters and moments are at most the replicated state's
    bytes over the world plus the leaves that stay whole over some axis
    (a size that does not divide it); the large leaves split."""
    for r in _shard(results, arch, shape):
        whole = sum(r["stay_whole"].values())
        assert r["held"] <= r["whole_bytes"] / r["world"] + whole
        assert r["held"] < r["whole_bytes"] / 2
        assert "tok" not in r["stay_whole"]


@pytest.mark.parametrize("arch,shape", R.SHARD_CASES, ids=SHARD_IDS)
def test_sharded_state_steps_match_the_replicated_steps(results, arch,
                                                         shape):
    for r in _shard(results, arch, shape):
        assert r["steps"] == R.SHARD_STEPS
        assert r["losses"]["sharded"] == r["losses"]["replicated"]
        bad = {k: e for k, e in r["blocks"].items() if e != 0.0}
        assert not bad, bad
        if arch.startswith(("mamba2", "zamba2")):
            H = 8 // shape[1]
            assert r["scan_heads"] == [H]


@pytest.mark.parametrize("arch,shape", R.SHARD_SP_CASES,
                         ids=[f"{a}_{s[0]}{s[1]}" for a, s in
                              R.SHARD_SP_CASES])
def test_sharded_sp_steps_use_the_stored_blocks(results, arch, shape):
    """On the SP path with a vocab-parallel lookup the sharded steps are
    the replicated steps' bits, while the FSDP blocks that _fsdp gathers
    (the SP projections' and the MoE's dimension d_model) and an untied
    table's vocabulary rows are used as stored, never all-gathered whole
    first; and make_train_step refuses a grad_transform on such a
    state."""
    fsdp_dims = {"attn.wq": 0, "attn.wk": 0, "attn.wv": 0, "attn.wo": 2,
                 "mlp.w_gate": 0, "mlp.w_up": 0, "mlp.w_down": 1,
                 "moe.w_gate": 1, "moe.w_up": 1, "moe.w_down": 2}
    for r in [r["shard_sp"][f"{arch}_{shape[0]}{shape[1]}"]
              for r in results[shape]]:
        assert r["refused"]
        assert r["losses"]["sharded"] == r["losses"]["replicated"]
        bad = {k: e for k, e in r["blocks"].items() if e != 0.0}
        assert not bad, bad
        assert r["gathered"]["tok"] == []
        checked = 0
        for name, dims in r["gathered"].items():
            leaf = ".".join(name.split(".")[-2:])
            if leaf in fsdp_dims:
                assert fsdp_dims[leaf] not in dims, (name, dims)
                checked += 1
        assert checked >= 2 * _n_layers(arch)


def _n_layers(arch):
    from repro_torch.configs import get_smoke_config

    return get_smoke_config(arch).n_layers


def test_sharded_checkpoint_restores_at_each_shape(results):
    """Saved from (2, 2) blocking and through CheckpointManager, restored
    with mesh=/pspecs= bit-equal at (2, 2), and at (1, 4) into a sharded
    state and into a replicated one (which comes back as blocks)."""
    r22 = [r["shard"]["checkpoint"] for r in results[(2, 2)]]
    for r in r22:
        assert r["sharded_bitequal"] and r["managed_bitequal"]
        assert r["managed_latest"] == (R.CKPT_STEP, True)
        assert r["latest"] == R.CKPT_STEP
    for r in results[(1, 4)]:
        got = r["shard"]["checkpoint"]["from_22"]
        assert got["sharded"] == 0.0 and got["replicated"] == 0.0
        assert got["sharded_step"] == got["replicated_step"] == \
            R.SHARD_STEPS


def test_sharded_checkpoint_restores_into_one_device_and_the_reference(
        results):
    """The whole leaves rank 0 saved come back from the sharded
    checkpoint through the one-device port and the reference."""
    import torch

    from repro.checkpoint import restore_checkpoint as jrestore
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.configs import get_smoke_config
    from repro_torch.training import AdamWConfig, init_train_state

    whole = results[(2, 2)][0]["shard"]["checkpoint"]["whole"]
    path = results["ckpt"] / "sharded"
    cfg = get_smoke_config(R.CKPT_ARCH).with_(dtype="float32", remat=True)
    one = restore_checkpoint(path, R.CKPT_STEP, init_train_state(
        cfg, AdamWConfig(), torch.Generator().manual_seed(11)))
    leaves = [t.detach().numpy() for t in _flatten(one)[0]]
    assert len(leaves) == len(whole)
    back = jrestore(path, R.CKPT_STEP, [np.zeros_like(w) for w in whole])
    for a, b, w in zip(leaves, back, whole):
        assert a.dtype == w.dtype and np.array_equal(a, w)
        assert np.asarray(b).dtype == w.dtype and np.array_equal(
            np.asarray(b), w)
    assert int(one.opt.step) == R.SHARD_STEPS


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
def test_reference_checkpoint_restores_into_a_sharded_state(results,
                                                            shape):
    for r in results[shape]:
        got = r["shard"]["checkpoint"]["reference"]
        assert got["sharded"] == 0.0 and got["replicated"] == 0.0
        assert got["sharded_step"] == got["replicated_step"] == 0


def test_part_takes_a_whole_weight_or_this_ranks_block_only():
    """A slicing site narrows a whole weight and passes this rank's stored
    block through; a weight that is neither raises instead of computing
    with the wrong block."""
    import torch

    from repro_torch.models.layers import _part

    w = torch.arange(32.0).reshape(4, 8)
    assert torch.equal(_part(w, 1, 8, slice(2, 4)), w[:, 2:4])
    assert torch.equal(_part(w, 1, 8, None), w)
    block = w[:, 2:4].clone()
    assert _part(block, 1, 8, slice(2, 4)) is block
    for bad, sl in ((w[:, :3], slice(2, 4)), (block, None)):
        with pytest.raises(ValueError):
            _part(bad, 1, 8, sl)
