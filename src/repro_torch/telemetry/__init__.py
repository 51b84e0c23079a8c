"""Run telemetry (port of ``repro/telemetry``): aggregation diagnostics,
the shared step metrics, JSONL run logging and per-phase timers."""
from repro_torch.telemetry.diagnostics import (AggDiagnostics,
                                               diagnostics_metrics,
                                               flat_diagnostics,
                                               masked_diagnostics,
                                               reduce_masked_diagnostics)
from repro_torch.telemetry.metrics import (health_metrics, honest_variance,
                                           staleness_metrics)
from repro_torch.telemetry.profiling import PhaseTimer
from repro_torch.telemetry.runlogger import RunLogger

__all__ = [
    "AggDiagnostics",
    "PhaseTimer",
    "RunLogger",
    "diagnostics_metrics",
    "flat_diagnostics",
    "health_metrics",
    "honest_variance",
    "masked_diagnostics",
    "reduce_masked_diagnostics",
    "staleness_metrics",
]
