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
store I/O timing), :mod:`repro_torch.workloads.batched` (the
``placement.bucket_pad_waste`` and ``placement.candidate_k`` gauges) and
the serving tick (:mod:`repro_torch.serving.horizon`: per-tick spans,
queue-depth and realized-QoS gauges, latency histograms).

Two more process-global recorders, each off by default and as
observational: the decision ledger (:mod:`~repro_torch.obs.ledger`, every
greedy pick and the Theorem-2 certificate) and the request tracer
(:mod:`~repro_torch.obs.reqtrace`, each request's lifecycle). Their files
are the reference's formats.
"""
from .metrics import (METRICS_SCHEMA_VERSION, Counter, Gauge, Histogram,
                      MetricsRegistry)
from .trace import (DEFAULT_CAPACITY, OBS_SCHEMA_VERSION,
                    READABLE_OBS_SCHEMAS, Tracer, count, disable, enable,
                    enable_from_env, enabled, get_tracer, load_artifact,
                    sample, save, span, to_chrome_trace,
                    validate_chrome_trace, kernel_span, get_publisher)
from .reqtrace import (REQTRACE_SCHEMA_VERSION, RequestTracer,
                       disable_request_tracing, enable_request_tracing,
                       enable_reqtrace_from_env, explain_uid,
                       get_request_tracer, load_reqtrace)
from .ledger import (LEDGER_SCHEMA_VERSION, DecisionLedger, disable_ledger,
                     enable_ledger, enable_ledger_from_env, get_ledger,
                     ingest_sparse_trace, load_ledger, why_text)

__all__ = [
    "OBS_SCHEMA_VERSION", "METRICS_SCHEMA_VERSION", "DEFAULT_CAPACITY",
    "READABLE_OBS_SCHEMAS",
    "Tracer", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "enable", "disable", "enabled", "get_tracer", "enable_from_env",
    "span", "count", "sample", "save",
    "load_artifact", "to_chrome_trace", "validate_chrome_trace",
    "kernel_span", "get_publisher",
    "REQTRACE_SCHEMA_VERSION", "RequestTracer", "enable_request_tracing",
    "disable_request_tracing", "get_request_tracer",
    "enable_reqtrace_from_env", "load_reqtrace", "explain_uid",
    "LEDGER_SCHEMA_VERSION", "DecisionLedger", "enable_ledger",
    "disable_ledger", "get_ledger", "enable_ledger_from_env",
    "ingest_sparse_trace", "load_ledger", "why_text",
]
