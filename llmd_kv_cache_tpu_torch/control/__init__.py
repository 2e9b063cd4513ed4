"""Self-driving fleet controller: close the loop from SLO burn to topology.

The observability planes are the fleet's *senses* — burn-rate
alerts, critical-path attribution, working-set what-if tables — and the
cluster/recovery planes are its *actuators* — ``HashRing``
join/leave with snapshot bootstrap, ``EngineConfig.role`` re-roling, and
graceful drain. This package is the loop between them: a reconciliation
controller that polls fleet signals, runs them through a hysteresis/
cooldown/budget policy, and emits concrete topology actions through a
pluggable actuator interface — every action journaled (crash-safe),
traced (``llm_d.kv_cache.control.*``), and dry-runnable.
"""

from .actions import (  # noqa: F401
    ACTION_ADD_SHARD,
    ACTION_DRAIN_POD,
    ACTION_REMOVE_SHARD,
    ACTION_SET_ROLE,
    Action,
    Actuator,
    AdminPlaneActuator,
    InProcessActuator,
)
from .config import ControllerConfig  # noqa: F401
from .controller import FleetController  # noqa: F401
from .journal import (  # noqa: F401
    ActionJournal,
    ActionRecord,
    last_settlement_ts,
    unresolved_actions,
)
from .policy import (  # noqa: F401
    ControlPolicy,
    Cooldown,
    Hysteresis,
    next_shard_name,
)
from .signals import CollectorSignalSource, FleetSignals  # noqa: F401
