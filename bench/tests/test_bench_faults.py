"""A run with the timed path broken underneath reads ``correct`` false:
the harness on the CPU at tiny sizes, past its look for a card, with each
fault a cell can have planted in the program — a step that returns its
state unchanged, half of the batch left out with the mean over the rest,
a served token altered where it is produced. (Every cell runs on one
card: there is no exchange between cards to leave out.)

The limits here are the tiny sizes' own: above what sound tiny runs read
(loss 0.0026, gradient norms 0.034, changes 0.042, logit gap 0.021 over
five seeds of each cell) and below what the faults read (half the batch:
0.026, 0.12 and 0.12 at the least; an unchanged state: a change of 1; an
altered token: 5.2)."""
import contextlib

import pytest
import torch

from bench import harness
from bench.tests import tiny

LIMITS = {"loss_gap": 0.01, "grad_norm_gap": 0.08, "change_norm_gap": 0.1,
          "logit_gap": 0.5}
TRAIN = ["mamba2-2p7b.train-4k"]
SERVE = ["mamba2-2p7b.score-1k"]


def _correct(root, cell, seed):
    return harness.run(["--workload", cell, "--seed", str(seed),
                        "--seconds", "0.2"], 0.0, root=root,
                       require_card=False)["correct"]


@contextlib.contextmanager
def _patched(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _half_batch():
    import repro_torch.models.transformer as T

    orig = T.loss_fn

    def half(model, cfg, batch, *a, **k):
        n = batch["tokens"].shape[0] // 2
        return orig(model, cfg, {key: v[:n] for key, v in batch.items()},
                    *a, **k)
    return _patched(T, "loss_fn", half)


def _unchanged_state():
    import repro_torch.training.trainer as TR

    def keep(grads, state, params, cfg, grad_norm=None):
        z = torch.zeros(())
        return state, {"grad_norm": z, "lr": z}
    return _patched(TR, "adamw_update_", keep)


def _altered_token():
    import repro_torch.models.transformer as T

    orig = T.prefill

    def prefill(*a, **k):
        logits, cache = orig(*a, **k)
        V = a[1].vocab_size
        logits = logits.clone()
        top = logits[:, :V].argmax(-1)
        logits[torch.arange(logits.shape[0]), (top + 1) % V] = \
            logits.max() + 10
        return logits, cache
    return _patched(T, "prefill", prefill)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("faults"), LIMITS)


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_sound_runs_are_correct(root, cell):
    assert _correct(root, cell, 2 ** 31 + 7)


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", [_half_batch, _unchanged_state])
def test_a_training_fault_is_not_correct(root, cell, fault):
    with fault():
        assert not _correct(root, cell, 2 ** 31 + 7)


@pytest.mark.parametrize("cell", SERVE)
def test_an_altered_token_is_not_correct(root, cell):
    with _altered_token():
        assert not _correct(root, cell, 2 ** 31 + 7)
