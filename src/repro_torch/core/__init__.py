"""The paper's primary contribution: the Digital Twin (object-mode and
struct-of-arrays), the single-node placement sweep and the ML placement
pipeline (scenario labelling, interpretable models), with the workload
generation and the Eq. (1) estimators they run on (copies of
``repro.core`` but its cluster parts, ROADMAP item 16)."""
from .digital_twin import DigitalTwin, DTResult, EstimatorExecutor  # noqa
from .fast_twin import FastEngine, FastTwin  # noqa
from .sweep import SweepRunner, SweepTask  # noqa
from .estimators import (FittedEstimators, MeasuredStepTimes,  # noqa
                         collect_benchmark, collect_memmax,
                         fit_estimators, fit_measured_step_times)
from .forest import (MODEL_ZOO, DecisionTree, LinearRegression,  # noqa
                     RandomForest, Ridge)
from .placement import (PlacementPoint, PlacementResult,  # noqa
                        default_slot_grid, find_optimal_placement)
from .pipeline import PlacementPipeline, build_pipeline  # noqa
from .dataset import (FEATURE_NAMES, PAPER_RANKS, PAPER_RATES,  # noqa
                      TARGET_NAMES, Scenario, encode_features,
                      label_scenarios, scenario_grid)
from .workload import (DATASETS, DriftPhase, WorkloadSpec,  # noqa
                       expected_prefix_hit_rate, generate_drifting_requests,
                       generate_requests, make_adapter_pool,
                       resample_requests, rotating_hot_phases)
