"""repro_torch.obs — determinism-safe tracing and metrics (the core of
:mod:`repro.obs`).

Span tracing with a preallocated ring buffer (:mod:`~repro_torch.obs.trace`)
and a counters/gauges/histograms registry (:mod:`~repro_torch.obs.metrics`).
The artifact schema is the reference's, so each package's
:func:`load_artifact` reads the other's.

Everything is **off by default** and strictly observational: enabling
tracing changes no stored sweep byte. Opt in with::

    from repro_torch import obs
    obs.enable()                      # or REPRO_OBS=1 in the environment
    with obs.span("sweep.chunk"):
        ...
    obs.save("trace.json")

``obs.enable(annotations=True)`` mirrors every span into
``torch.profiler.record_function``, so the spans show in a torch/CUDA
profile. Instrumented: :mod:`repro_torch.sweeps` (per-chunk spans, items/s,
store I/O timing) and :mod:`repro_torch.workloads.batched` (the
``placement.bucket_pad_waste`` and ``placement.candidate_k`` gauges).
"""
from .metrics import (METRICS_SCHEMA_VERSION, Counter, Gauge, Histogram,
                      MetricsRegistry)
from .trace import (DEFAULT_CAPACITY, OBS_SCHEMA_VERSION,
                    READABLE_OBS_SCHEMAS, Tracer, count, disable, enable,
                    enable_from_env, enabled, get_tracer, load_artifact,
                    sample, save, span, to_chrome_trace,
                    validate_chrome_trace)

__all__ = [
    "OBS_SCHEMA_VERSION", "METRICS_SCHEMA_VERSION", "DEFAULT_CAPACITY",
    "READABLE_OBS_SCHEMAS",
    "Tracer", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "enable", "disable", "enabled", "get_tracer", "enable_from_env",
    "span", "count", "sample", "save",
    "load_artifact", "to_chrome_trace", "validate_chrome_trace",
]
