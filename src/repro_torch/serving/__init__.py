"""repro_torch.serving — the EI serving control and data plane: the
request router (OMS on the device), the model server (prefill + decode of
a resident model), the service catalog, the edge cluster (placement
driving resident model servers, realized QoS from measured latency), and
the serving tick (placement with hysteresis → routing → continuous
batching over a horizon, host NumPy, byte-identical to the
reference's)."""
from .catalog import (Catalog, ServiceModel, default_catalog,
                      with_quantized_variants)
from .cluster import EdgeCluster, EdgeGroup, ServeReport
from .engine import BatchResult, ModelServer, Request
from .horizon import (HorizonConfig, HorizonResult, TickReport,
                      run_horizon, split_serving_overrides)
from .router import Router, RoutingDecision
from .scheduler import (ArrivingRequest, ContinuousScheduler,
                        ExecutorProfile, simulate)

__all__ = ["BatchResult", "ModelServer", "Request", "Router",
           "RoutingDecision",
           "Catalog", "ServiceModel", "default_catalog",
           "with_quantized_variants",
           "EdgeCluster", "EdgeGroup", "ServeReport",
           "ArrivingRequest", "ContinuousScheduler", "ExecutorProfile",
           "simulate",
           "HorizonConfig", "HorizonResult", "TickReport", "run_horizon",
           "split_serving_overrides"]
