"""Phase timers, the profiler trace and the serving export of the port
(counterpart of ``localregneuralde_tpu/utils``)."""
from .export import (
    export_fn,
    export_model,
    export_model_multi,
    load_exported,
    save_exported,
)
from .profiling import PhaseTimer, trace

__all__ = [
    "PhaseTimer",
    "trace",
    "export_fn",
    "export_model",
    "export_model_multi",
    "load_exported",
    "save_exported",
]
