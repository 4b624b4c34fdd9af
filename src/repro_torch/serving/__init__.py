"""repro_torch.serving — the request router (OMS on the device) and the
model server (prefill + decode of a resident dense model)."""
from .engine import BatchResult, ModelServer, Request
from .router import Router, RoutingDecision

__all__ = ["BatchResult", "ModelServer", "Request", "Router",
           "RoutingDecision"]
