"""Per-rank argument bytes at ``pod2x16x16`` (FSDP over ``("pod",
"data")``, 512 fake ranks) for one arch of each family and every kind of
cell: the port's against the reference's, equal once
tests/torch_dryrun_bytes.py's listed terms are out."""
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


@pytest.mark.parametrize("arch,shape", DB.cells(DB.FAMILY_ARCHS))
def test_multi_pod_argument_bytes_are_the_reference_s(arch, shape, world):
    ref, got, terms = DB.check(arch, shape, True, world)
    single = DB.listed(arch, shape, False)[0]
    # the state splits over 32 data-parallel ranks, not 16
    assert ref < single
