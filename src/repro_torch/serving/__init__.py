"""Serving engine (copies of repro.serving modules), the torch executor and
the plan-level placement router.  The JAX package's cluster, fault,
rebalancing and gateway modules are not ported yet (ROADMAP item 16)."""
from .adapter_cache import AdapterSlotCache  # noqa
from .engine import EngineConfig, ServingEngine  # noqa
from .executor import (HardwareProfile, StepTiming,  # noqa
                       SyntheticExecutor, TorchExecutor)
from .kv_cache import PagedKVCache  # noqa
from .prefix_cache import PrefixEntry, SharedPrefixCache  # noqa
from .metrics import ServingMetrics, smape, smape_vec, summarize  # noqa
from .request import Adapter, Request  # noqa
from .scheduler import Scheduler, StepPlan  # noqa
from .policy import (SCHED_POLICIES, SchedulingPolicy, SchedView,  # noqa
                     make_sched_policy, register_sched_policy,
                     sched_policy_index)
from .router import PlacementRouter, ReplicaPlan, RouterState  # noqa
