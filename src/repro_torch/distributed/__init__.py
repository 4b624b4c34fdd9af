"""repro_torch.distributed — the elastic runtime's host-side planning
(survivor mesh, batch plan, stragglers, recovery)."""
from .elastic import (ClusterState, StragglerMonitor, elastic_batch_plan,
                      plan_survivor_mesh, recovery_plan)

__all__ = ["ClusterState", "StragglerMonitor", "plan_survivor_mesh",
           "elastic_batch_plan", "recovery_plan"]
