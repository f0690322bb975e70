"""repro_torch.ft: fault injection and the training watchdog (the JAX
package's ``repro.ft``)."""
from repro_torch.ft.inject import FaultPlan, FaultSpec, SimulatedPreemption
from repro_torch.ft.watchdog import (Heartbeat, StragglerDetector,
                                     TrainSupervisor, elastic_remesh_plan)

__all__ = ["FaultPlan", "FaultSpec", "SimulatedPreemption",
           "Heartbeat", "StragglerDetector", "TrainSupervisor",
           "elastic_remesh_plan"]
