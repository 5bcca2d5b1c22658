"""The port's observability plane, the JAX package's ``obs`` exports.

``aggregate`` merges N instances' scrapes (counters sum, histograms merge
bucket by bucket, quantiles recomputed from the merged buckets);
``collector`` is the ``ObsCollector``, which scrapes every registered
component endpoint on the shared event loop and serves the fleet's
``/metrics``, ``/debug/traces``, ``/debug/topology`` and
``/debug/flightrecorder``; ``appmetrics`` is the registry a workload
embeds to export its SLIs; ``scorecard`` judges declarative SLOs with
multi-window burn rates over the collector's scrapes; ``timeline`` merges
the endpoints' flight-recorder rings and traces into one time-ordered
list.
"""

from .aggregate import (  # noqa: F401
    ParsedMetrics,
    bucket_quantile,
    merge_metrics,
    merge_parsed,
    parse_metrics_text,
    render_metrics,
    select,
)
from .appmetrics import (  # noqa: F401
    AppMetrics,
    sample_value,
    scrape_annotations,
    scrape_target,
)
from .collector import ObsCollector  # noqa: F401
from .scorecard import SLO, Scorecard  # noqa: F401
from .timeline import capture as capture_timeline  # noqa: F401
