"""Distribution (port of ``repro.distributed``): the one-device train step
and the fault-tolerance machinery.  Sharding, the mesh steps and
gradient compression arrive with the port's ``DeviceMesh`` slice."""
from .fault_tolerance import (FailureInjector, InjectedFailure,
                              StragglerDetector, Watchdog, plan_elastic_mesh)
from .steps import StepBundle, make_train_step

__all__ = ["FailureInjector", "InjectedFailure", "StragglerDetector",
           "Watchdog", "plan_elastic_mesh", "StepBundle", "make_train_step"]
