"""repro_torch.distributed — the elastic runtime's host-side planning
(survivor mesh, batch plan, stragglers, recovery), gradient compression
with error feedback, and the mesh's collectives (``collectives``)."""
from . import collectives
from .compression import (ErrorFeedback, compressed_psum, int8_compress,
                          int8_round, topk_compress)
from .elastic import (ClusterState, StragglerMonitor, elastic_batch_plan,
                      plan_survivor_mesh, recovery_plan)

__all__ = ["ClusterState", "StragglerMonitor", "plan_survivor_mesh",
           "elastic_batch_plan", "recovery_plan", "ErrorFeedback",
           "topk_compress", "int8_compress", "int8_round",
           "compressed_psum", "collectives"]
