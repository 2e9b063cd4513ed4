"""Resilience primitives: copies of the JAX package's
``resilience.failpoints``, ``resilience.policy`` and
``resilience.integrity`` (the offload tier's), ``resilience.deadline``
(end-to-end request deadlines) and ``resilience.shedding`` (CoDel-style
admission shedding), ``resilience.failover`` (the degraded-mode
index) and ``resilience.hedging`` (the shard router's latency quantiles and
hedge budget). The deadline, hedging and shedding names are exported here,
as the JAX package's ``resilience/__init__.py`` exports them."""

from .deadline import (  # noqa: F401
    Deadline,
    DeadlineExceeded,
    current_deadline,
    deadline_scope,
    effective_timeout,
)
from .hedging import HedgeBudget, LatencyQuantileTracker  # noqa: F401
from .shedding import (  # noqa: F401
    ADMIT,
    BROWNOUT,
    PRIORITY_CRITICAL,
    PRIORITY_LOW,
    PRIORITY_NORMAL,
    SHED,
    CoDelShedder,
    OverloadShedError,
)
