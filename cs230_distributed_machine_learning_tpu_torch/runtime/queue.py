"""In-process topic bus: the Kafka replacement.

A copy of the JAX package's ``runtime/queue.py`` (framework-free). The
reference moves every control/feedback message through four Kafka topics
(``tasks``/``train``/``result``/``metrics`` — ``docker-compose.yml:56``) with
worker routing via message keys. The control plane lives in one
coordinator process per host, so the bus is a thread-safe in-process pub-sub:
``publish(topic, msg)`` fans out to every subscriber queue. Keyed routing
(scheduler -> one worker) is just a per-executor subscriber with a filter,
mirroring the reference's key==worker_id consumption (``worker.py:185-186``)
without broker round-trips. The same interface is what a DCN-backed
implementation plugs into for multi-host (runtime/agent.py).
"""

from __future__ import annotations

import heapq
import itertools
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class TopicBus:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._subs: Dict[str, List["Subscription"]] = {}

    def subscribe(
        self,
        topic: str,
        key_filter: Optional[Callable[[Any], bool]] = None,
        priority: bool = False,
        aging_s: Optional[float] = None,
    ) -> "Subscription":
        """``priority=True`` makes this subscription a QoS lane consumer
        (docs/ARCHITECTURE.md "QoS priority lanes"): delivery order is by
        the message's ``priority`` field (higher first; dict messages
        only, default lane 0), FIFO within a lane. The dispatch-side
        subscriptions (task ingress, per-worker train queues) opt in so a
        heavy tenant's backlog cannot starve a higher-priority session;
        result/metrics subscriptions stay plain FIFO.

        Strict priority alone starves: under a sustained high-lane flood
        a lane-0 message would wait forever. Priority subscriptions
        therefore age — a waiting message is promoted one lane per
        ``aging_s`` seconds of queue age (default: the ``qos_aging_s``
        scheduler config knob; <= 0 restores pure strict priority), so
        bounded starvation is the contract, not unbounded."""
        sub = Subscription(
            self, topic, key_filter, priority=priority, aging_s=aging_s
        )
        with self._lock:
            self._subs.setdefault(topic, []).append(sub)
        return sub

    def unsubscribe(self, sub: "Subscription") -> None:
        with self._lock:
            subs = self._subs.get(sub.topic, [])
            if sub in subs:
                subs.remove(sub)

    def publish(self, topic: str, message: Any, key: Any = None) -> int:
        delivered = 0
        with self._lock:
            subs = list(self._subs.get(topic, []))
        for sub in subs:
            if sub.key_filter is None or sub.key_filter(key):
                sub._put(key, message)
                delivered += 1
        return delivered

    def depth(self, topic: str) -> int:
        """Undelivered messages parked on the topic's subscriber queues —
        an overload signal (`GET /healthz` bus_depths): a deep `train`
        backlog means placements are outrunning the executors."""
        with self._lock:
            subs = list(self._subs.get(topic, []))
        return sum(len(s) for s in subs)

    def depths(self) -> Dict[str, int]:
        # one lock hold: a consistent cross-topic snapshot, not N+1
        # acquisitions contending with the publish path
        with self._lock:
            return {
                t: sum(len(s) for s in subs)
                for t, subs in self._subs.items()
            }


class Subscription:
    def __init__(
        self, bus: TopicBus, topic: str, key_filter,
        priority: bool = False, aging_s: Optional[float] = None,
    ) -> None:
        self._bus = bus
        self.topic = topic
        self.key_filter = key_filter
        self._priority = priority
        if priority and aging_s is None:
            from ..utils.config import get_config

            aging_s = get_config().scheduler.qos_aging_s
        self._aging_s = float(aging_s or 0.0)
        #: throttle stamp for the lazy promotion sweep
        self._last_promote = 0.0
        #: tie-break sequence: FIFO within a priority lane (PriorityQueue
        #: would otherwise compare the message dicts and raise)
        self._seq = itertools.count()
        self._q: "queue.Queue" = (
            queue.PriorityQueue() if priority else queue.Queue()
        )

    @staticmethod
    def _message_priority(message: Any) -> int:
        if isinstance(message, dict):
            try:
                return int(message.get("priority") or 0)
            except (TypeError, ValueError):
                return 0
        return 0

    def _put(self, key: Any, message: Any) -> None:
        if self._priority:
            prio = self._message_priority(message)
            # entry: (-effective_lane, seq, enqueue_ts, base_lane, key,
            # message) — the consumer-facing get()s slice the last two
            self._q.put(
                (-prio, next(self._seq), time.time(), prio, key, message)
            )
        else:
            self._q.put((key, message))

    def _promote_aged(self) -> None:
        """QoS lane aging: raise a waiting entry's effective lane by one
        per ``aging_s`` seconds of queue age, so a sustained high-lane
        flood cannot starve low lanes forever (bounded starvation:
        worst-case wait ~= lane_gap x aging_s). Runs lazily at consume
        time, throttled — order only matters when entries are waiting,
        and every get() re-checks."""
        if not self._priority or self._aging_s <= 0:
            return
        now = time.time()
        if now - self._last_promote < min(1.0, self._aging_s / 4):
            return
        self._last_promote = now
        q = self._q
        with q.mutex:
            heap = q.queue
            changed = False
            for i, (neg_lane, seq, ts, base, key, msg) in enumerate(heap):
                eff = base + int((now - ts) // self._aging_s)
                if eff > -neg_lane:
                    heap[i] = (-eff, seq, ts, base, key, msg)
                    changed = True
            if changed:
                heapq.heapify(heap)

    def get(self, timeout: Optional[float] = None):
        """Returns (key, message); raises queue.Empty on timeout."""
        self._promote_aged()
        item = self._q.get(timeout=timeout)
        return item[-2:] if self._priority else item

    def get_nowait(self):
        self._promote_aged()
        item = self._q.get_nowait()
        return item[-2:] if self._priority else item

    def close(self) -> None:
        self._bus.unsubscribe(self)

    def __len__(self) -> int:
        return self._q.qsize()
