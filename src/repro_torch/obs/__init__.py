"""repro_torch.obs — unified observability for the serving stack.

The JAX package's ``repro.obs``, kept as its own copy here (it imports
nothing of JAX): the same spans, exports, validators, metrics and alerts, so
a run of the port's server can be held against the JAX server's event for
event.

Three pillars (the measurement substrate every perf PR is judged against):

* :mod:`tracing`  — low-overhead request-lifecycle tracing: a bounded
  ring-buffer :class:`Tracer` collecting span/instant/counter events with
  causal request/batch/launch IDs, emitted by the server, batcher,
  co-scheduler, and cluster layers (host-tagged in cluster mode);
* :mod:`export`   — Chrome ``trace_event`` / Perfetto rendering of a trace
  (open the JSON in https://ui.perfetto.dev), with per-host process tracks,
  per-class device tracks for launch groups, and counter tracks for queue
  depth / ring depth / controller setpoints;
* :mod:`ledger`   — the live penalty ledger: per-launch modeled-cycle
  attribution (the paper's modelled TPU v4 cycles, not the card's time)
  into MXU-productive work vs VPU Montgomery-fold stalls
  (arithmetic penalty, paper §7.2) vs M/K padding (spatial penalty, §7.3)
  vs host/gather gaps, published in every telemetry snapshot;
* :mod:`validate` — trace-file schema validator (balanced spans, every
  request reaching a terminal ``complete``/``reject`` event) — the CI
  contract for ``--trace-out`` files, plus the OpenMetrics exposition
  validator backing ``--metrics-out``;
* :mod:`metrics`  — continuous metrics: a collector-driven
  :class:`MetricsRegistry` scraped on a fixed serving-clock cadence into
  bounded time-series rings, exposed as OpenMetrics text (and optionally
  over HTTP in wall-clock mode) — deterministic under the virtual clock;
* :mod:`alerts`   — SLO alerting over the scraped series: multi-window
  multi-burn-rate and threshold rules driving a pending→firing→resolved
  state machine, with firings emitted as Tracer instants on the Perfetto
  timeline.
"""
from repro_torch.obs.alerts import (AlertEngine, BurnRateRule,
                                    ThresholdRule, default_cluster_rules,
                                    default_serve_rules, merge_alert_sections)
from repro_torch.obs.export import (chrome_trace, read_text,
                                    write_chrome_trace, write_text)
from repro_torch.obs.ledger import (PenaltyLedger, launch_cycles,
                                    merge_penalty_sections)
from repro_torch.obs.metrics import (MetricsRegistry, expose_registries,
                                     serve_metrics_http)
from repro_torch.obs.tracing import Tracer
from repro_torch.obs.validate import validate_chrome_trace, validate_openmetrics

__all__ = [
    "Tracer", "chrome_trace", "write_chrome_trace", "PenaltyLedger",
    "merge_penalty_sections", "launch_cycles", "validate_chrome_trace",
    "validate_openmetrics", "MetricsRegistry", "expose_registries",
    "serve_metrics_http", "AlertEngine", "BurnRateRule", "ThresholdRule",
    "default_serve_rules", "default_cluster_rules", "merge_alert_sections",
    "read_text", "write_text",
]
