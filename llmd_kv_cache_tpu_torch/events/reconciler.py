"""Pod discovery → subscriber lifecycle reconciliation.

Copy of ``llmd_kv_cache_tpu/events/reconciler.py`` (``kubernetes`` is
imported inside ``KubernetesDiscovery``, as there). Counterpart of
reference ``examples/kv_events/pod_reconciler`` (a
controller-runtime watch driving ``SubscriberManager.EnsureSubscriber``).
Discovery is pluggable:

- ``KubernetesDiscovery``: watches pods by label selector via the official
  client when importable (in-cluster deployments)
- ``StaticDiscovery``: fixed pod→endpoint map (config-file deployments)
- ``FileDiscovery``: polls a JSON file ``{"pod-name": "tcp://ip:5557"}`` —
  the test/compose-friendly source; anything that can write a file can
  drive discovery

The reconcile loop is source-agnostic: ensure subscribers for present
pods, remove for departed ones. Crash-only: unreachable endpoints are
harmless (the subscriber retries forever until the pod is removed).
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Optional, Protocol

from ..utils.logging import get_logger
from .pool import PodDiscoveryConfig
from .subscriber_manager import SubscriberManager

logger = get_logger("events.reconciler")


class DiscoverySource(Protocol):
    def discover(self) -> dict[str, str]:
        """Return the current pod-name → ZMQ endpoint map."""
        ...


class StaticDiscovery:
    def __init__(self, pods: dict[str, str]):
        self._pods = dict(pods)

    def discover(self) -> dict[str, str]:
        return dict(self._pods)

    def set(self, pods: dict[str, str]) -> None:
        self._pods = dict(pods)


class FileDiscovery:
    """Reads a JSON pod map from a file; missing file means no pods."""

    def __init__(self, path: str):
        self.path = path

    def discover(self) -> dict[str, str]:
        try:
            with open(self.path) as f:
                data = json.load(f)
            return {str(k): str(v) for k, v in data.items()}
        except (FileNotFoundError, json.JSONDecodeError):
            return {}


class KubernetesDiscovery:
    """Lists ready pods by label selector via the kubernetes client.

    Endpoint per pod: ``tcp://<pod-ip>:<socket_port>`` (reference
    ``pod_reconciler.go:86-162``). Requires the optional ``kubernetes``
    package and in-cluster or kubeconfig credentials — unless a
    ``core_api`` is injected (tests stub the CoreV1Api surface;
    ``discover`` itself is then exercised without a cluster).
    """

    def __init__(self, cfg: PodDiscoveryConfig, core_api=None):
        if core_api is not None:
            self._core = core_api
            self.cfg = cfg
            return
        try:
            from kubernetes import client, config as k8s_config
        except ImportError as e:  # pragma: no cover - optional dep
            raise RuntimeError(
                "KubernetesDiscovery requires the 'kubernetes' package"
            ) from e
        try:
            k8s_config.load_incluster_config()
        except Exception:  # pragma: no cover - local kubeconfig fallback
            k8s_config.load_kube_config()
        self._core = client.CoreV1Api()
        self.cfg = cfg

    def discover(self) -> dict[str, str]:
        kwargs = {"label_selector": self.cfg.pod_label_selector}
        if self.cfg.pod_namespace:
            pods = self._core.list_namespaced_pod(self.cfg.pod_namespace, **kwargs)
        else:
            pods = self._core.list_pod_for_all_namespaces(**kwargs)
        result = {}
        for pod in pods.items:
            if pod.status.pod_ip and pod.status.phase == "Running":
                result[pod.metadata.name] = (
                    f"tcp://{pod.status.pod_ip}:{self.cfg.socket_port}"
                )
        return result


class PodReconciler:
    """Periodic reconcile loop between a discovery source and the
    SubscriberManager."""

    def __init__(
        self,
        source: DiscoverySource,
        manager: SubscriberManager,
        interval_s: float = 5.0,
        on_change: Optional[Callable[[dict[str, str]], None]] = None,
    ):
        self.source = source
        self.manager = manager
        self.interval_s = interval_s
        self.on_change = on_change
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def reconcile_once(self) -> tuple[int, int]:
        """One reconcile pass; returns (added_or_updated, removed)."""
        try:
            desired = self.source.discover()
        except Exception:
            logger.exception("discovery failed; keeping current subscribers")
            return (0, 0)

        changed = 0
        for pod, endpoint in desired.items():
            if self.manager.ensure_subscriber(pod, endpoint):
                changed += 1
        removed = 0
        for pod in self.manager.pods():
            if pod not in desired:
                self.manager.remove_subscriber(pod)
                removed += 1
        if (changed or removed) and self.on_change is not None:
            self.on_change(desired)
        return changed, removed

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                self.reconcile_once()
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(target=loop, name="pod-reconciler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
