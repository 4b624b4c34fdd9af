"""Per-rank argument bytes of every production cell at ``pod16x16``: the
port's dry run (the bytes of ``build_cell``'s fake arguments, on a fake
256-rank process group) against the reference's arguments split by their
specs, equal once tests/torch_dryrun_bytes.py's listed terms are out (the
leaves ``leaf_split`` keeps whole, the conv cache's rule, the inputs the
port takes whole, the reference's ``Cache.pos``)."""
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
    # at pod16x16 every state, parameter and cache leaf divides its axes:
    # what differs is the conv cache, the whole inputs and Cache.pos
    assert not [k for k in terms if k.startswith("kept")]
    assert {k.split(" ")[0].split("[")[0] for k in terms} <= {
        "conv", "inputs", "pos"}
