"""The autouse fixture of the port's control-plane tests: both packages'
process-global recorders — the obs tracer, the decision ledger, the
request tracer and the live stream publisher — are off when a test starts,
and a test leaves them off (a recorder left on breaks the next test file
on the same xdist worker). Where the JAX package is not installed (a card
machine), the port's alone."""
import pytest

from repro_torch import obs as tobs
from repro_torch.obs import ledger as tledger
from repro_torch.obs import reqtrace as treqtrace

try:
    from repro import obs as robs
    from repro.obs import ledger as rledger
    from repro.obs import reqtrace as rreqtrace
    OBS, LEDGERS, REQTRACERS = ((tobs, robs), (tledger, rledger),
                                (treqtrace, rreqtrace))
except ImportError:
    OBS, LEDGERS, REQTRACERS = (tobs,), (tledger,), (treqtrace,)


@pytest.fixture(autouse=True)
def recorders_off():
    for mod in OBS:
        assert not mod.enabled()
        assert mod.get_publisher() is None
    for mod in LEDGERS:
        assert mod._LEDGER is None
    for mod in REQTRACERS:
        assert mod._REQTRACER is None
    yield
    for mod in OBS:
        mod.disable()
        mod.disable_stream()
    for mod in LEDGERS:
        mod.disable_ledger()
    for mod in REQTRACERS:
        mod.disable_request_tracing()
