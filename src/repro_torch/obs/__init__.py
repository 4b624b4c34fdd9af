"""repro_torch.obs — determinism-safe tracing, metrics, live telemetry and
trace export (the port of :mod:`repro.obs`).

Span tracing with a preallocated ring buffer (:mod:`~repro_torch.obs.trace`),
a counters/gauges/histograms registry (:mod:`~repro_torch.obs.metrics`), a
``torch.profiler`` adapter (:mod:`~repro_torch.obs.torchprof`), the live
telemetry stream (:mod:`~repro_torch.obs.stream`), declarative SLOs and the
benchmark regression gate (:mod:`~repro_torch.obs.slo`), trace stitching
and metric rollups (:mod:`~repro_torch.obs.aggregate`), a terminal
dashboard (:mod:`~repro_torch.obs.dash`) and a CLI (``python -m
repro_torch.obs report|export|tail|dash|stitch|explain|why|slo``). Every
file format and wire protocol is the reference's, so either package reads
the other's artifacts and streams.

Everything is **off by default** and strictly observational: enabling
tracing or streaming changes no stored sweep byte and no ``TickReport``
field. Opt in with::

    from repro_torch import obs
    obs.enable()                      # or REPRO_OBS=1 in the environment
    obs.enable_stream("/tmp/s.jsonl") # or REPRO_OBS_STREAM=/tmp/s.jsonl
    with obs.span("sweep.chunk"):
        ...
    obs.save("trace.json")

While a ``torch.profiler`` collects, every span also enters a
``torch.profiler.record_function`` of its name, ring on or off, so the
spans show in a torch/CUDA profile. Instrumented: the training step
(:mod:`repro_torch.training.trainer`: ``train.step``, ``train.forward``,
``train.backward``, ``train.optimizer``), ``ModelServer.generate``
(``serve.generate``, ``serve.init_cache``, ``serve.prefill``,
``serve.decode_step``, ``serve.readback``), :mod:`repro_torch.sweeps`
(per-chunk spans, items/s, store I/O timing, ``chunk`` frames),
:mod:`repro_torch.workloads.batched`
(the ``placement.bucket_pad_waste`` and ``placement.candidate_k`` gauges),
the QoS kernel dispatchers (``kernel.qos_matrix`` and
``kernel.qos_candidates`` spans, a profiler range around each CUDA or
plain branch), the serving tick (:mod:`repro_torch.serving.horizon`:
per-tick spans, queue-depth and realized-QoS gauges, latency histograms,
``tick`` and ``horizon`` frames) and the gateway
(:mod:`repro_torch.gateway`: ``gateway`` and ``metrics`` frames).

Two more process-global recorders, each off by default and as
observational: the decision ledger (:mod:`~repro_torch.obs.ledger`, every
greedy pick and the Theorem-2 certificate) and the request tracer
(:mod:`~repro_torch.obs.reqtrace`, each request's lifecycle).
"""
from .metrics import (METRICS_SCHEMA_VERSION, Counter, Gauge, Histogram,
                      MetricsRegistry)
from .trace import (DEFAULT_CAPACITY, OBS_SCHEMA_VERSION,
                    READABLE_OBS_SCHEMAS, Tracer, count, disable, enable,
                    enable_from_env, enabled, get_tracer, load_artifact,
                    sample, save, span, to_chrome_trace,
                    validate_chrome_trace)
from .torchprof import (have_torch_profiler, kernel_span, named_scope,
                        profile_trace)
from .stream import (STREAM_SCHEMA_VERSION, StreamPublisher, disable_stream,
                     enable_stream, enable_stream_from_env, get_publisher,
                     publish, read_stream, stream_active)
from .aggregate import (rollup_counters, rollup_metrics, stitch_fleet,
                        stitch_traces)
from .slo import (DEFAULT_SLOS, SLO, SLO_SCHEMA_VERSION, SLOReport,
                  compare_bench, evaluate_slos, load_slos)
from .reqtrace import (REQTRACE_SCHEMA_VERSION, RequestTracer,
                       disable_request_tracing, enable_request_tracing,
                       enable_reqtrace_from_env, explain_uid,
                       get_request_tracer, load_reqtrace)
from .ledger import (LEDGER_SCHEMA_VERSION, DecisionLedger, disable_ledger,
                     enable_ledger, enable_ledger_from_env, get_ledger,
                     ingest_sparse_trace, load_ledger, why_text)

__all__ = [
    "OBS_SCHEMA_VERSION", "METRICS_SCHEMA_VERSION", "DEFAULT_CAPACITY",
    "READABLE_OBS_SCHEMAS", "STREAM_SCHEMA_VERSION", "SLO_SCHEMA_VERSION",
    "Tracer", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "enable", "disable", "enabled", "get_tracer", "enable_from_env",
    "span", "count", "sample", "save",
    "load_artifact", "to_chrome_trace", "validate_chrome_trace",
    "kernel_span", "named_scope", "profile_trace", "have_torch_profiler",
    "StreamPublisher", "enable_stream", "disable_stream", "stream_active",
    "get_publisher", "publish", "read_stream", "enable_stream_from_env",
    "stitch_traces", "stitch_fleet", "rollup_metrics", "rollup_counters",
    "SLO", "SLOReport", "DEFAULT_SLOS", "load_slos", "evaluate_slos",
    "compare_bench",
    "REQTRACE_SCHEMA_VERSION", "RequestTracer", "enable_request_tracing",
    "disable_request_tracing", "get_request_tracer",
    "enable_reqtrace_from_env", "load_reqtrace", "explain_uid",
    "LEDGER_SCHEMA_VERSION", "DecisionLedger", "enable_ledger",
    "disable_ledger", "get_ledger", "enable_ledger_from_env",
    "ingest_sparse_trace", "load_ledger", "why_text",
]
