"""Distribution (port of ``repro.distributed``): sharding rules, the
train / prefill / decode step builders on one device or a
``DeviceMesh``, gradient compression, and the fault-tolerance
machinery."""
from .fault_tolerance import (FailureInjector, InjectedFailure,
                              StragglerDetector, Watchdog, make_elastic_mesh,
                              plan_elastic_mesh)
from .sharding import (batch_pspecs, cache_shardings, logical_rules,
                       param_shardings, pspec_for_param)
from .steps import (StepBundle, TrainState, abstract_cache, abstract_params,
                    abstract_train_state, input_specs, make_decode_step,
                    make_prefill_step, make_train_step)

__all__ = [
    "batch_pspecs", "cache_shardings", "logical_rules", "param_shardings",
    "pspec_for_param", "TrainState", "abstract_cache", "abstract_params",
    "abstract_train_state", "input_specs", "make_decode_step",
    "make_prefill_step", "make_train_step",
    "FailureInjector", "InjectedFailure", "StragglerDetector", "Watchdog",
    "make_elastic_mesh", "plan_elastic_mesh", "StepBundle",
]
