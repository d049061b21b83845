"""Jiagu's core, ported: pre-decision scheduling + dual-staged scaling
(the paper's contribution), the RFR predictor with its torch and CUDA
inference engines, the prediction service, the cluster simulator and
its cell-sharded event core, the harvesting scheduler, and the
K8s/Gsight/Owl baselines.  The platform facade over all of it is
``core.platform`` (``repro_torch.platform``)."""
from .autoscaler import (Autoscaler, ScalingConfig, ScalingMetrics,
                         SchedulerCapacityProvider)
from .capacity import QOS_MULT, QoSStore, capacity_of, update_capacity_table
from .cells import (CapacityExchange, Cell, CellRouter, CellSimulation,
                    cell_scenario_simulation)
from .cluster import CapEntry, Cluster, FuncState, Node
from .events import EventHub, JsonlObserver, Observer
from .harvesting import HarvestingScheduler
from .interference import GroundTruth, NodeResources
from .metrics import Reservoir
from .pipeline import (CandidatePass, DecisionContext, DecisionTrace,
                       PipelineGsightScheduler, PipelineHostMixin,
                       PipelineJiaguScheduler, PipelineK8sScheduler,
                       PipelineOwlScheduler, SchedulingPipeline,
                       TraceBinding)
from .prediction_service import (DRAIN_MODES, INFERENCE_ENGINES,
                                 SCHEMA_V1, SCHEMA_V2, CapacityEngine,
                                 EngineConfig, EngineStats, FeatureSchema,
                                 PredictionService, coloc_signature,
                                 get_schema)
from .predictor import (MODEL_ZOO, ForestArrays, PerfPredictor,
                        RandomForestRegressor, build_features,
                        forest_from_numpy, resolve_device)
from .profiles import (BENCH_FUNCTIONS, FunctionSpec, ProfileStore,
                       arch_functions, synthetic_functions)
from .scheduler import (FAST_PATH_MS, REROUTE_MS, BaseScheduler,
                        GsightScheduler, JiaguScheduler, K8sScheduler,
                        OwlScheduler, SchedulerBuildContext,
                        SchedulerEntry, build_scheduler,
                        register_scheduler, registered_schedulers,
                        scheduler_entry)
from .scenarios import (LARGE_NODE, SCENARIO_KINDS, STANDARD_NODE,
                        NodeClass, Scenario, ScenarioWorld,
                        build_simulation, get_scenario_builder,
                        make_scenario, register_scenario,
                        registered_scenarios, scale_trace_to_nodes,
                        scenario_functions, scenario_simulation,
                        scenario_suite, scenario_world, zipf_weights)
from .simulator import (EqualSplitRouter, LocalityRouter, SimConfig,
                        SimResult, Simulation, generate_dataset)
from .traces import (Trace, azure_sparse_trace, burst_storm_trace,
                     coldstart_churn_trace, diurnal_shift_trace, flip_trace,
                     get_trace, realworld_suite, realworld_trace,
                     register_trace, registered_traces, replay_trace,
                     timer_trace)

__all__ = [
    "Autoscaler", "ScalingConfig", "ScalingMetrics", "QOS_MULT", "QoSStore",
    "SchedulerCapacityProvider", "EventHub", "Observer", "EqualSplitRouter",
    "SchedulerBuildContext", "SchedulerEntry", "build_scheduler",
    "register_scheduler", "registered_schedulers", "scheduler_entry",
    "get_scenario_builder", "register_scenario", "registered_scenarios",
    "get_trace", "register_trace", "registered_traces",
    "CapacityEngine", "EngineConfig", "EngineStats", "coloc_signature",
    "PredictionService", "FeatureSchema", "SCHEMA_V1", "SCHEMA_V2",
    "DRAIN_MODES", "INFERENCE_ENGINES",
    "get_schema", "Reservoir", "replay_trace",
    "capacity_of", "update_capacity_table", "CapEntry", "Cluster",
    "FuncState", "Node", "GroundTruth", "NodeResources", "MODEL_ZOO",
    "ForestArrays", "PerfPredictor", "RandomForestRegressor",
    "build_features", "forest_from_numpy", "resolve_device",
    "BENCH_FUNCTIONS", "FunctionSpec", "ProfileStore", "arch_functions",
    "synthetic_functions", "FAST_PATH_MS", "REROUTE_MS", "BaseScheduler",
    "GsightScheduler", "JiaguScheduler", "K8sScheduler", "OwlScheduler",
    "Cell", "CellRouter", "CellSimulation", "CapacityExchange",
    "cell_scenario_simulation",
    "SimConfig", "SimResult", "Simulation", "generate_dataset", "Trace",
    "JsonlObserver", "LocalityRouter", "HarvestingScheduler",
    "CandidatePass", "DecisionContext", "DecisionTrace", "TraceBinding",
    "SchedulingPipeline", "PipelineHostMixin", "PipelineJiaguScheduler",
    "PipelineGsightScheduler", "PipelineK8sScheduler",
    "PipelineOwlScheduler",
    "flip_trace", "realworld_suite", "realworld_trace", "timer_trace",
    "burst_storm_trace", "diurnal_shift_trace", "coldstart_churn_trace",
    "azure_sparse_trace", "NodeClass", "Scenario", "ScenarioWorld",
    "STANDARD_NODE", "LARGE_NODE", "SCENARIO_KINDS", "build_simulation",
    "make_scenario", "scenario_functions", "scenario_simulation",
    "scenario_suite", "scenario_world", "scale_trace_to_nodes",
    "zipf_weights",
]
