"""Serving stack of the port: request lifecycle + CostEngine scheduler,
slot-pooled decode state (dense, or paged with the radix prefix cache of
``paging.py``), the static and continuous engines (deadlines, priority
preemption, a bounded queue, graceful stop), fault injection and the
watchdogged, retried device step (``faults.py``), and the multi-process
front end with its token streams (``frontend/``).

Names resolve lazily, as in ``repro_torch``: a spawned front-end worker
imports ``repro_torch.serving.frontend.workers`` and the scheduler's
request validation, and must not load the engine (and torch) for it."""

_EXPORTS = {
    "ContinuousServeEngine": "repro_torch.serving.engine",
    "ServeEngine": "repro_torch.serving.engine",
    "ServeReport": "repro_torch.serving.engine",
    "emitted_count": "repro_torch.serving.engine",
    "FatalFault": "repro_torch.serving.faults",
    "FaultInjector": "repro_torch.serving.faults",
    "FaultSpec": "repro_torch.serving.faults",
    "InjectedFault": "repro_torch.serving.faults",
    "StepFailed": "repro_torch.serving.faults",
    "WatchdogTimeout": "repro_torch.serving.faults",
    "guarded_call": "repro_torch.serving.faults",
    "AffinityPlan": "repro_torch.serving.frontend",
    "FrontendConfig": "repro_torch.serving.frontend",
    "FrontendError": "repro_torch.serving.frontend",
    "FrontendStream": "repro_torch.serving.frontend",
    "HostTopology": "repro_torch.serving.frontend",
    "ServingFrontend": "repro_torch.serving.frontend",
    "StreamBroken": "repro_torch.serving.frontend",
    "StreamEvent": "repro_torch.serving.frontend",
    "TokenStream": "repro_torch.serving.frontend",
    "discover": "repro_torch.serving.frontend",
    "plan_affinity": "repro_torch.serving.frontend",
    "BlockPool": "repro_torch.serving.paging",
    "PrefixMatch": "repro_torch.serving.paging",
    "default_kv_blocks": "repro_torch.serving.paging",
    "InvalidRequestError": "repro_torch.serving.scheduler",
    "Request": "repro_torch.serving.scheduler",
    "RequestState": "repro_torch.serving.scheduler",
    "ServeScheduler": "repro_torch.serving.scheduler",
    "supports_chunked_prefill": "repro_torch.serving.scheduler",
    "validate_request": "repro_torch.serving.scheduler",
    "SlotPool": "repro_torch.serving.slots",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'repro_torch.serving' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(module), name)
    globals()[name] = value  # cache: subsequent lookups skip __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
