"""The paper's Digital Twin (object-mode and struct-of-arrays) and
placement sweep, with the workload generation and the Eq. (1) estimators
they run on (copies of parts of ``repro.core``)."""
from .digital_twin import DigitalTwin, DTResult, EstimatorExecutor  # noqa
from .fast_twin import FastEngine, FastTwin  # noqa
from .estimators import (FittedEstimators, MeasuredStepTimes,  # noqa
                         collect_benchmark, collect_memmax,
                         fit_estimators, fit_measured_step_times)
from .placement import (PlacementPoint, PlacementResult,  # noqa
                        default_slot_grid, find_optimal_placement)
from .workload import (DATASETS, DriftPhase, WorkloadSpec,  # noqa
                       expected_prefix_hit_rate, generate_drifting_requests,
                       generate_requests, make_adapter_pool,
                       resample_requests, rotating_hot_phases)
