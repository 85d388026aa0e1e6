"""Pluggable scheduling policies: the admission/preemption decision seam.

The paper's whole premise is that starvation is a *policy* outcome — the
(N, G) placement model is trained against vLLM's fixed FCFS +
loaded-adapter-priority scheduler.  This module turns that scheduler
into one point in a policy space, shared verbatim by all three
consumers:

  * ``serving.scheduler.Scheduler`` — the real engine and the
    object-mode Digital Twin (they already share the scheduler);
  * ``core.fast_twin.FastEngine`` — the struct-of-arrays twin fast
    path, which keeps its SoA layout and delegates only the admission
    *ordering* (and optional victim choice) to the policy.

A policy never touches resources.  The mechanical admission loop —
adapter-slot eligibility, KV admission check with head-of-line blocking,
``max_running``, the skip of requests preempted this very step — is
identical across policies and consumers; the policy decides the *order*
in which waiting requests are offered to that loop and may veto the
default preemption victim.  Because both consumers feed the policy the
same (arrival, adapter, context-length, residency) values, one policy
instance produces bit-identical decisions on either side — the
per-policy fast-vs-legacy equivalence tests in ``tests/test_fast_twin``
enforce it.

Registered policies (``SCHED_POLICIES``; add your own with
``@register_sched_policy``):

  * ``fcfs``            — today's behaviour, byte-identical metrics as
                          the default: arrival order with vLLM's
                          loaded-adapter priority (the eligibility skip
                          is in the mechanical loop, so every policy
                          inherits it).
  * ``slo-priority``    — deadline ordering: each adapter belongs to a
                          priority class and its requests are served in
                          order of ``arrival + slo_base * class``, with
                          an aging term so a low-priority request's
                          extra wait is bounded by
                          ``slo_base * class / (1 + aging)`` — low
                          classes cannot starve.
  * ``adapter-fair``    — deficit round-robin across adapters: the head
                          request of every waiting adapter is offered
                          before any adapter's second request, adapters
                          with the smallest cumulative admitted tokens
                          (the deficit counter) first — one hot adapter
                          cannot monopolize admission slots.
  * ``adapter-cluster`` — S-LoRA-style clustering: requests whose
                          adapter is already resident are offered first,
                          grouped per adapter, so same-adapter work
                          batches and cold loads (the Fig. 4 cost) are
                          deferred.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Type, Union


class SchedView:
    """Accessor protocol a consumer hands to the policy.

    ``item`` is whatever the consumer queues: a ``Request`` object in the
    object-mode scheduler, a struct-of-arrays row id in ``FastEngine``.
    Implementations must return the *same* values for the same logical
    request on either side (floats bit-identical), which is what makes
    policy decisions consumer-independent.
    """

    def arrival(self, item) -> float:
        raise NotImplementedError

    def adapter(self, item) -> int:
        raise NotImplementedError

    def context_len(self, item) -> int:
        raise NotImplementedError

    def resident(self, adapter: int) -> bool:
        raise NotImplementedError


SCHED_POLICIES: Dict[str, Type["SchedulingPolicy"]] = {}


def register_sched_policy(cls: Type["SchedulingPolicy"]
                          ) -> Type["SchedulingPolicy"]:
    SCHED_POLICIES[cls.name] = cls
    return cls


def make_sched_policy(policy: Union[str, "SchedulingPolicy", None],
                      **kwargs) -> "SchedulingPolicy":
    """Resolve a policy name to a fresh instance.

    A ``SchedulingPolicy`` *instance* is passed through as-is — the
    caller owns its lifetime, and sharing one stateful instance between
    engines shares its fairness state (each engine still ``reset()``s it
    at stream start)."""
    if policy is None:
        policy = "fcfs"
    if isinstance(policy, SchedulingPolicy):
        return policy
    if policy not in SCHED_POLICIES:
        raise ValueError(f"unknown scheduling policy {policy!r}; "
                         f"have {sorted(SCHED_POLICIES)}")
    return SCHED_POLICIES[policy](**kwargs)


def sched_policy_index(name: str) -> int:
    """Stable numeric encoding of a policy name (placement-model
    feature): its position in *registration order*, so registering a
    new policy appends an index and never shifts the encoding of
    already-labelled datasets or trained models."""
    try:
        return list(SCHED_POLICIES).index(name)
    except ValueError:
        raise ValueError(f"unknown scheduling policy {name!r}; "
                         f"have {sorted(SCHED_POLICIES)}")


class SchedulingPolicy:
    """Base policy: admission order + optional hooks.

    Subclasses override ``order`` (and optionally ``on_admit`` /
    ``victim``).  ``order`` must be side-effect free on the queue it is
    given and deterministic in (items, view state, own state) — both
    scheduler implementations call it with identical inputs and must
    reach identical decisions.
    """

    name = ""

    def reset(self) -> None:
        """Drop accumulated state (new request stream)."""

    def order(self, items: Sequence, view: SchedView, now: float) -> Sequence:
        """Admission attempt order — a permutation of ``items``.

        The mechanical loop walks this order applying the shared
        eligibility rules; returning ``items`` unchanged is FCFS.
        """
        return items

    def on_admit(self, item, view: SchedView, now: float) -> None:
        """Called after ``item`` is admitted (charge fairness state)."""

    def victim(self, running: Sequence, view: SchedView) -> Optional[object]:
        """Preemption victim among ``running`` (None = nothing to evict).

        Default is the engine's preempt-by-recompute rule: the most
        recently arrived running request.  Consumers keep their native
        (vectorized) implementation of this default and only call in
        when a subclass overrides it.
        """
        if not running:
            return None
        return max(running, key=view.arrival)


# used by consumers to skip virtual dispatch on the hot path when the
# policy doesn't customise a hook
def overrides_on_admit(policy: SchedulingPolicy) -> bool:
    return type(policy).on_admit is not SchedulingPolicy.on_admit


def overrides_victim(policy: SchedulingPolicy) -> bool:
    return type(policy).victim is not SchedulingPolicy.victim


@register_sched_policy
class FCFSPolicy(SchedulingPolicy):
    """Arrival order (today's vLLM-style behaviour, the default)."""

    name = "fcfs"


@register_sched_policy
class SLOPriorityPolicy(SchedulingPolicy):
    """Deadline/TTFT-aware ordering with aging.

    Each adapter belongs to a priority class (``priorities`` mapping, or
    ``adapter_uid % n_classes`` when unspecified; class 0 is most
    urgent).  A request's deadline is ``arrival + slo_base * class`` and
    admission is attempted in order of
    ``deadline - aging * (now - arrival)`` — i.e. class-c work may be
    overtaken by newer urgent work for at most ``slo_base * c / (1 +
    aging)`` seconds of extra waiting, after which it wins every
    comparison: aging bounds the priority boost, so low-priority
    adapters cannot starve.
    """

    name = "slo-priority"

    def __init__(self, slo_base: float = 5.0, aging: float = 0.5,
                 priorities: Optional[Dict[int, int]] = None,
                 n_classes: int = 4):
        self.slo_base = slo_base
        self.aging = aging
        self.priorities = dict(priorities or {})
        self.n_classes = max(int(n_classes), 1)

    def priority_of(self, adapter: int) -> int:
        return self.priorities.get(adapter, adapter % self.n_classes)

    def order(self, items: Sequence, view: SchedView, now: float) -> List:
        def key(item):
            arr = view.arrival(item)
            deadline = arr + self.slo_base * self.priority_of(
                view.adapter(item))
            return (deadline - self.aging * (now - arr), arr)
        return sorted(items, key=key)


@register_sched_policy
class AdapterFairPolicy(SchedulingPolicy):
    """Deficit round-robin across adapters.

    Admission order is lexicographic on (position within the adapter's
    own waiting queue, cumulative admitted prefill tokens — the deficit
    counter, arrival): the head request of every waiting adapter is
    offered before any adapter's second request, least-served adapters
    first.  ``on_admit`` charges the admitted context to the adapter, so
    an adapter that monopolized slots sinks behind the others the next
    time a slot frees.
    """

    name = "adapter-fair"

    def __init__(self):
        self._served: Dict[int, float] = {}

    def reset(self) -> None:
        self._served.clear()

    def order(self, items: Sequence, view: SchedView, now: float) -> List:
        depth: Dict[int, int] = {}
        keyed = []
        for item in items:
            a = view.adapter(item)
            k = depth.get(a, 0)
            depth[a] = k + 1
            keyed.append(((k, self._served.get(a, 0.0),
                           view.arrival(item)), item))
        keyed.sort(key=lambda kv: kv[0])
        return [item for _, item in keyed]

    def on_admit(self, item, view: SchedView, now: float) -> None:
        a = view.adapter(item)
        self._served[a] = self._served.get(a, 0.0) \
            + view.context_len(item) + 1


@register_sched_policy
class AdapterClusterPolicy(SchedulingPolicy):
    """S-LoRA-style adapter clustering.

    Requests whose adapter is already resident are offered first (their
    admission needs no slot and batches with running same-adapter work);
    within each group, adapters are visited oldest-waiting-first and a
    whole adapter's queue is offered contiguously — same-adapter work
    clusters into the batch and cold loads are taken one adapter at a
    time instead of thrashing the LRU.
    """

    name = "adapter-cluster"

    def order(self, items: Sequence, view: SchedView, now: float) -> List:
        oldest: Dict[int, float] = {}
        for item in items:
            a = view.adapter(item)
            if a not in oldest:
                oldest[a] = view.arrival(item)

        def key(item):
            a = view.adapter(item)
            return (0 if view.resident(a) else 1, oldest[a], a,
                    view.arrival(item))
        return sorted(items, key=key)
