"""Per-rank argument bytes of every production cell at ``pod16x16``: the
port's dry run (the bytes of ``build_cell``'s fake arguments, on a fake
256-rank process group) against the reference's arguments split by their
specs, equal once tests/torch_dryrun_bytes.py's listed terms are out: at
``pod16x16`` only the reference's ``Cache.pos`` (the inputs are
``shard_batch``'s blocks, the conv cache a rank's ``1/model`` of its
channels, as the reference splits them)."""
import pytest

jax = pytest.importorskip("jax")

import torch_dryrun_bytes as DB  # noqa: E402
from torch_recorders import recorders_off  # noqa: E402,F401  (autouse)


@pytest.fixture(scope="module")
def world():
    w = DB.FakeWorld()
    try:
        yield w
    finally:
        w.close()


@pytest.mark.parametrize("arch,shape", DB.cells())
def test_argument_bytes_a_rank_are_the_reference_s(arch, shape, world):
    ref, got, terms = DB.check(arch, shape, False, world)
    assert got > 0 and ref > 0
    # at pod16x16 every leaf divides its axes: what differs is Cache.pos
    assert set(terms) <= {"pos"}, terms
