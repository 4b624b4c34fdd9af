"""repro_torch.serving — the request router (OMS on the device)."""
from .router import Router, RoutingDecision

__all__ = ["Router", "RoutingDecision"]
