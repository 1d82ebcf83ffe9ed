"""repro_torch — the PyTorch/CUDA port of ``repro``, for one NVIDIA H100.

The public surface mirrors ``repro``: a :class:`Runtime` session owning the
device, the CostEngine and the overhead ledger, training through
``Runtime.train`` and serving through ``Runtime.serve``.  Dense
projections, the FFN, the unembedding and the contractions of cached
attention run on a hand-written CUDA matmul kernel (``csrc/matmul.cu``),
forward and backward; causal attention without a cache on hand-written
flash kernels (``csrc/flash_attention.cu``), forward and backward; and the
paper's sort domain (``distributed_sort(local_sort="kernel")``) on a
hand-written bitonic sort kernel (``csrc/bitonic_sort.cu``), all built at
first use into ``build/``; on CPU tensors each kernel's plain PyTorch
version runs instead.

    import repro_torch

    rt = repro_torch.Runtime()                     # the GPU
    cfg = repro_torch.get_config("tinyllama-1.1b")
    trace = repro_torch.synthetic_trace(8, prompt_len=64, max_new=32,
                                        vocab_size=cfg.vocab_size)
    served = rt.serve(cfg, trace, slots=4, eos_id=-1)
    paged = rt.serve(cfg, trace, slots=4, eos_id=-1, paged=True,
                     prefix_cache="auto", stream=True)
    trained = rt.train(cfg, steps=4, batch=2, seq=2048)
    print(rt.ledger.report())

Attributes resolve lazily, as in ``repro``.  This package imports neither
``jax`` nor ``repro``.
"""

__version__ = "0.1.0"

__all__ = [
    # session object + config
    "Runtime",
    "RuntimeConfig",
    "ServeResult",
    "TrainResult",
    "default_runtime",
    "set_default_runtime",
    "synthetic_trace",
    # architectures + model construction
    "ModelConfig",
    "get_config",
    "list_configs",
    "ShapeSpec",
    "build_model",
    # training
    "TrainLoopConfig",
    "AdamWConfig",
    # serving types
    "Request",
    "RequestState",
    "InvalidRequestError",
    "ServeReport",
    "FrontendConfig",
    "TokenStream",
    # serving faults (drills and the guarded device step)
    "FaultInjector",
    "FaultSpec",
    "FatalFault",
    "InjectedFault",
    "StepFailed",
    "WatchdogTimeout",
    # cost subsystem (the Runtime's internals, exposed for injection)
    "CorrectionState",
    "CostEngine",
    "CostQuery",
    "Decision",
    "OverheadLedger",
    "OverheadModel",
    "HardwareSpec",
    "H100",
    # the paper's domains on one device
    "adaptive_matmul",
    "analyze_dependencies",
    "distributed_sort",
    "fork_join",
    "matmul_chain",
]

_EXPORTS = {
    "Runtime": "repro_torch.runtime",
    "RuntimeConfig": "repro_torch.runtime",
    "ServeResult": "repro_torch.runtime",
    "TrainResult": "repro_torch.runtime",
    "default_runtime": "repro_torch.runtime",
    "set_default_runtime": "repro_torch.runtime",
    "synthetic_trace": "repro_torch.runtime",
    "ModelConfig": "repro_torch.configs",
    "get_config": "repro_torch.configs",
    "list_configs": "repro_torch.configs",
    "ShapeSpec": "repro_torch.configs",
    "TrainLoopConfig": "repro_torch.training",
    "AdamWConfig": "repro_torch.optim",
    "build_model": "repro_torch.models",
    "Request": "repro_torch.serving",
    "RequestState": "repro_torch.serving",
    "InvalidRequestError": "repro_torch.serving",
    "ServeReport": "repro_torch.serving",
    "FrontendConfig": "repro_torch.serving",
    "TokenStream": "repro_torch.serving",
    "FaultInjector": "repro_torch.serving",
    "FaultSpec": "repro_torch.serving",
    "FatalFault": "repro_torch.serving",
    "InjectedFault": "repro_torch.serving",
    "StepFailed": "repro_torch.serving",
    "WatchdogTimeout": "repro_torch.serving",
    "CorrectionState": "repro_torch.core.costs",
    "CostEngine": "repro_torch.core.costs",
    "CostQuery": "repro_torch.core.costs",
    "Decision": "repro_torch.core.costs",
    "OverheadLedger": "repro_torch.core.costs",
    "OverheadModel": "repro_torch.core.costs",
    "HardwareSpec": "repro_torch.hw",
    "H100": "repro_torch.hw",
    "adaptive_matmul": "repro_torch.core",
    "analyze_dependencies": "repro_torch.core",
    "distributed_sort": "repro_torch.core",
    "fork_join": "repro_torch.core",
    "matmul_chain": "repro_torch.core",
}


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(module), name)
    globals()[name] = value  # cache: subsequent lookups skip __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
