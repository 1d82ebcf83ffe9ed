"""repro_torch — the PyTorch/CUDA port of ``repro``, for one NVIDIA H100.

The public surface mirrors ``repro``: a :class:`Runtime` session owning the
device, the CostEngine and the overhead ledger, and serving through
``Runtime.serve``.  Dense projections, the FFN, the unembedding and the
contractions of cached attention run on a hand-written CUDA matmul kernel
(``csrc/matmul.cu``, built at first use into ``build/``); on CPU tensors
each kernel's plain PyTorch version runs instead.

    import repro_torch

    rt = repro_torch.Runtime()                     # the GPU
    cfg = repro_torch.get_config("tinyllama-1.1b")
    trace = repro_torch.synthetic_trace(8, prompt_len=64, max_new=32,
                                        vocab_size=cfg.vocab_size)
    served = rt.serve(cfg, trace, slots=4, eos_id=-1)
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
    "synthetic_trace",
    # architectures + model construction
    "ModelConfig",
    "get_config",
    "list_configs",
    "build_model",
    # serving types
    "Request",
    "RequestState",
    "InvalidRequestError",
    "ServeReport",
    # cost subsystem (the Runtime's internals, exposed for injection)
    "CorrectionState",
    "CostEngine",
    "CostQuery",
    "Decision",
    "OverheadLedger",
    "OverheadModel",
    "HardwareSpec",
    "H100",
]

_EXPORTS = {
    "Runtime": "repro_torch.runtime",
    "RuntimeConfig": "repro_torch.runtime",
    "ServeResult": "repro_torch.runtime",
    "synthetic_trace": "repro_torch.runtime",
    "ModelConfig": "repro_torch.configs",
    "get_config": "repro_torch.configs",
    "list_configs": "repro_torch.configs",
    "build_model": "repro_torch.models",
    "Request": "repro_torch.serving",
    "RequestState": "repro_torch.serving",
    "InvalidRequestError": "repro_torch.serving",
    "ServeReport": "repro_torch.serving",
    "CorrectionState": "repro_torch.core.costs",
    "CostEngine": "repro_torch.core.costs",
    "CostQuery": "repro_torch.core.costs",
    "Decision": "repro_torch.core.costs",
    "OverheadLedger": "repro_torch.core.costs",
    "OverheadModel": "repro_torch.core.costs",
    "HardwareSpec": "repro_torch.hw",
    "H100": "repro_torch.hw",
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
