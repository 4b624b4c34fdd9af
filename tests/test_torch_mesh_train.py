"""Training on the port's device mesh against the reference's, on the CPU:
the Mamba2 and Zamba2 stacks and the audio and vision frontends under a
mesh context, ``run_training(mesh=)``
with one checkpoint writer and every rank resuming, and
``compressed_psum`` with the autograd collectives under it.

As in tests/test_torch_mesh.py: the reference in one subprocess on a
4-device host platform with Auto axes, the port in one spawn of 4 gloo
ranks per mesh shape. mamba2 and zamba2 (smoke configs, float32) at
(data, model) = (4, 1), hubert and internvl2 at (2, 2): the gathered
final hidden within 1e-5 of the
reference's, the loss and every gradient leaf within 1e-4 (of the leaf's
largest |value|) of ``jax.grad`` under the mesh and of the port's
one-device gradient. ``run_training(mesh=..., steps=3)`` of mixtral at
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

CASE_SP = [(c, sp) for c in R.SSM_CASES + R.FRONTEND_CASES
           for sp in c.sps]
IDS = [f"{c.name}-sp{int(sp)}" for c, sp in CASE_SP]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """One spawn of 4 ranks a mesh shape: (4, 1) runs the SSM cases and
    its training case, (2, 2) the frontends, its training cases, the
    checkpoint resume and the compressed psum."""
    ref = R.run_reference(str(tmp_path_factory.mktemp("mesh_ref")), "train")
    out = {}
    for shape in ((4, 1), (2, 2)):
        work = [("train", "train_cases",
                 ([c for c in R.TRAIN_CASES if c[1] == shape], ref,
                  str(tmp_path_factory.mktemp(f"ckpt_{shape[0]}{shape[1]}"))
                  ))]
        if shape == (4, 1):
            work.append(("models", "model_cases", (R.SSM_CASES, ref)))
        else:
            work += [("models", "model_cases", (R.FRONTEND_CASES, ref)),
                     ("psum", "compressed_psum_case", ())]
        tmp = tmp_path_factory.mktemp(f"train_ranks_{shape[0]}{shape[1]}")
        out[shape] = R.spawn(R.jobs, 4, str(tmp), *work)
    return out


@pytest.mark.parametrize("case,sp", CASE_SP, ids=IDS)
def test_ssm_and_frontends_match_the_reference_mesh(results, case, sp):
    ranks = [r["models"][case.name][sp] for r in results[case.shape]]
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
