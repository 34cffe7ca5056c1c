"""Schedulers: discrete-event tick scheduler + sample-indexed RT schedule.

Re-designs of scheduler.rs:240 (TickScheduler — virtual time,
time-scale control, subscribers, sleep queue) and rt_scheduler.rs:814
(RealTimeScheduler — TX/RX state machine with guards/priorities).

Batch-first stance (SURVEY.md §2.9): wall-clock hop/TDMA timing becomes
*sample-indexed* schedules computed up front — `SampleSchedule` produces
per-sample event masks/ids that kernels consume directly, so timing is
exact-by-construction instead of jitter-bounded.
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
import time
from typing import Callable

import numpy as np


# --------------------------------------------------------------------------
# Discrete-event tick scheduler (virtual time)
# --------------------------------------------------------------------------


@dataclasses.dataclass(order=True)
class _Event:
    tick: int
    seq: int
    callback: Callable = dataclasses.field(compare=False)
    period: int | None = dataclasses.field(compare=False, default=None)
    name: str = dataclasses.field(compare=False, default="")


class TickScheduler:
    """Deterministic DES over virtual ticks (scheduler.rs:240).

    Time scale (pause/slow/fast) is a run-loop property, not simulation
    state: `run_until` advances virtual time deterministically; use
    `time_scale` only when co-simulating against a wall clock.
    """

    def __init__(self, tick_rate_hz: float = 1000.0):
        self.tick_rate_hz = tick_rate_hz
        self.current_tick = 0
        self.time_scale = 1.0  # 0 = paused, >1 = faster than real time
        self._heap: list[_Event] = []
        self._seq = 0
        self._subscribers: dict[str, Callable] = {}

    # -- registration ------------------------------------------------------
    def schedule_at(self, tick: int, callback: Callable, name: str = ""):
        heapq.heappush(self._heap,
                       _Event(tick, self._next_seq(), callback, None, name))

    def schedule_in(self, delay_ticks: int, callback: Callable,
                    name: str = ""):
        self.schedule_at(self.current_tick + delay_ticks, callback, name)

    def schedule_periodic(self, period_ticks: int, callback: Callable,
                          name: str = "", start: int | None = None):
        first = self.current_tick + (period_ticks if start is None else start)
        heapq.heappush(self._heap, _Event(first, self._next_seq(), callback,
                                          period_ticks, name))

    def subscribe(self, name: str, on_tick: Callable):
        """Per-tick subscriber (scheduler.rs TickSubscriber:106)."""
        self._subscribers[name] = on_tick

    def unsubscribe(self, name: str):
        self._subscribers.pop(name, None)

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    # -- execution ----------------------------------------------------------
    def step(self, n_ticks: int = 1):
        for _ in range(n_ticks):
            self.current_tick += 1
            while self._heap and self._heap[0].tick <= self.current_tick:
                ev = heapq.heappop(self._heap)
                ev.callback(self.current_tick)
                if ev.period:
                    heapq.heappush(
                        self._heap,
                        _Event(ev.tick + ev.period, self._next_seq(),
                               ev.callback, ev.period, ev.name),
                    )
            for cb in list(self._subscribers.values()):
                cb(self.current_tick)

    def run_until(self, tick: int):
        if tick > self.current_tick:
            self.step(tick - self.current_tick)

    @property
    def virtual_time_s(self) -> float:
        return self.current_tick / self.tick_rate_hz


# --------------------------------------------------------------------------
# Sample-indexed schedules (the batch-first rt_scheduler replacement)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScheduledEvent:
    """One TX/RX window (rt_scheduler.rs events, sample-indexed)."""

    start_sample: int
    duration_samples: int
    kind: str = "tx"  # tx | rx | hop | guard
    channel: int = 0
    priority: int = 0


class SampleSchedule:
    """Event timeline resolved to sample indices.

    `masks(n)` renders per-sample boolean masks / channel ids that
    batched kernels consume — hop/TDMA timing becomes data, with zero
    jitter by construction (vs the reference's 80-118 µs p99 wall-clock
    hop timing, MEASURABLE_OBJECTIVES.md:72).
    """

    def __init__(self, sample_rate: float):
        self.sample_rate = sample_rate
        self.events: list[ScheduledEvent] = []

    def add(self, event: ScheduledEvent):
        self.events.append(event)

    def add_at_time(self, t_s: float, duration_s: float, **kw):
        self.add(ScheduledEvent(
            start_sample=int(round(t_s * self.sample_rate)),
            duration_samples=int(round(duration_s * self.sample_rate)), **kw
        ))

    def add_hop_pattern(self, channels, dwell_s: float, start_s: float = 0.0):
        """TDMA/FHSS hop windows back-to-back (rt_scheduler hop usage)."""
        dwell = int(round(dwell_s * self.sample_rate))
        s0 = int(round(start_s * self.sample_rate))
        for i, ch in enumerate(np.asarray(channels)):
            self.add(ScheduledEvent(s0 + i * dwell, dwell, kind="hop",
                                    channel=int(ch)))

    def masks(self, n_samples: int):
        """(active_mask bool[n], channel_id int32[n], kind_id int32[n])."""
        active = np.zeros(n_samples, bool)
        channel = np.full(n_samples, -1, np.int32)
        kind = np.full(n_samples, -1, np.int32)
        kind_ids = {"tx": 0, "rx": 1, "hop": 2, "guard": 3}
        for ev in sorted(self.events, key=lambda e: e.priority):
            a = max(ev.start_sample, 0)
            b = min(ev.start_sample + ev.duration_samples, n_samples)
            if b > a:
                active[a:b] = True
                channel[a:b] = ev.channel
                kind[a:b] = kind_ids.get(ev.kind, -1)
        return active, channel, kind

    def conflicts(self) -> list[tuple[ScheduledEvent, ScheduledEvent]]:
        """Overlapping same-kind events (guard-condition check)."""
        evs = sorted(self.events, key=lambda e: e.start_sample)
        out = []
        for a, b in zip(evs, evs[1:]):
            if (a.start_sample + a.duration_samples > b.start_sample
                    and a.kind == b.kind):
                out.append((a, b))
        return out


# ----------------------------------------------------- RT scheduler
#
# Re-design of rt_scheduler.rs:814 RealTimeScheduler: the event model
# (deadline + priority + guard + repeat + source), the radio state
# machine with TX/RX turnaround states, pluggable clock sources, and
# missed-deadline accounting. Deadlines are nanoseconds on the chosen
# clock; the MockClock makes every behavior deterministic under test
# (rt_scheduler.rs:148 MockClock).


class ClockSource(enum.Enum):
    """rt_scheduler.rs:66 ClockSource ladder. SYSTEM and MOCK are live;
    HPET/TSC collapse to SYSTEM on this host (time.monotonic_ns is the
    best monotonic source Python exposes); GPS adds a configured offset
    (a disciplined-oscillator stand-in)."""

    SYSTEM = "system"
    HPET = "hpet"
    TSC = "tsc"
    GPS = "gps"
    MOCK = "mock"


class SystemClock:
    def now_ns(self) -> int:
        return time.monotonic_ns()


class GpsClock:
    """System clock + fixed GPS offset (disciplined-clock stand-in)."""

    def __init__(self, offset_ns: int = 0):
        self.offset_ns = offset_ns

    def now_ns(self) -> int:
        return time.monotonic_ns() + self.offset_ns


class MockClock:
    """Manually advanced clock for deterministic tests
    (rt_scheduler.rs:148)."""

    def __init__(self, start_ns: int = 0):
        self._ns = start_ns

    def now_ns(self) -> int:
        return self._ns

    def advance_ns(self, delta: int):
        self._ns += delta

    def set_ns(self, ns: int):
        self._ns = ns


class RadioState(enum.Enum):
    """rt_scheduler.rs:185-237 radio state machine."""

    IDLE = "idle"
    TRANSMITTING = "transmitting"
    TX_TURNAROUND = "tx_turnaround"
    RECEIVING = "receiving"
    RX_TURNAROUND = "rx_turnaround"
    HOPPING = "hopping"
    CALIBRATING = "calibrating"
    ERROR = "error"

    def can_transmit(self) -> bool:
        return self in (RadioState.IDLE, RadioState.RX_TURNAROUND)

    def can_receive(self) -> bool:
        return self in (RadioState.IDLE, RadioState.TX_TURNAROUND)

    def can_hop(self) -> bool:
        return self in (RadioState.IDLE, RadioState.TX_TURNAROUND,
                        RadioState.RX_TURNAROUND)


_VALID_TRANSITIONS: dict[RadioState, tuple[RadioState, ...]] = {
    RadioState.IDLE: (RadioState.TRANSMITTING, RadioState.RECEIVING,
                      RadioState.HOPPING, RadioState.CALIBRATING,
                      RadioState.ERROR),
    RadioState.TRANSMITTING: (RadioState.TX_TURNAROUND, RadioState.ERROR),
    RadioState.TX_TURNAROUND: (RadioState.IDLE, RadioState.RECEIVING,
                               RadioState.HOPPING, RadioState.ERROR),
    RadioState.RECEIVING: (RadioState.RX_TURNAROUND, RadioState.ERROR),
    RadioState.RX_TURNAROUND: (RadioState.IDLE, RadioState.TRANSMITTING,
                               RadioState.HOPPING, RadioState.ERROR),
    RadioState.HOPPING: (RadioState.IDLE, RadioState.ERROR),
    RadioState.CALIBRATING: (RadioState.IDLE, RadioState.ERROR),
    RadioState.ERROR: (RadioState.IDLE,),
}


class RadioStateError(RuntimeError):
    pass


@dataclasses.dataclass
class RtEvent:
    """Deadline event (rt_scheduler.rs:432 ScheduledEvent): priority 0
    is highest; guard is a predicate over the current RadioState."""

    deadline_ns: int
    action: Callable[[], None]
    priority: int = 128
    guard: Callable[[RadioState], bool] | None = None
    repeat_interval_ns: int | None = None
    source: str = ""
    id: int = dataclasses.field(default_factory=itertools.count().__next__)

    def check_guard(self, state: RadioState) -> bool:
        return self.guard is None or bool(self.guard(state))


@dataclasses.dataclass
class RtSchedulerStats:
    """rt_scheduler.rs:625 SchedulerStats."""

    executed: int = 0
    missed_deadlines: int = 0
    guard_blocked: int = 0
    cancelled: int = 0
    max_lateness_ns: int = 0


class RealTimeScheduler:
    """Wall-clock deadline scheduler with guards, priorities, radio
    state machine, and turnaround enforcement (rt_scheduler.rs:814)."""

    def __init__(self, clock_source: ClockSource = ClockSource.SYSTEM,
                 clock=None,
                 tx_rx_turnaround_ns: int = 100_000,
                 rx_tx_turnaround_ns: int = 100_000,
                 deadline_tolerance_ns: int = 1_000_000):
        if clock is None:
            if clock_source == ClockSource.MOCK:
                clock = MockClock()
            elif clock_source == ClockSource.GPS:
                clock = GpsClock()
            else:  # SYSTEM / HPET / TSC -> best monotonic source
                clock = SystemClock()
        self.clock = clock
        self.clock_source = clock_source
        self.tx_rx_turnaround_ns = tx_rx_turnaround_ns
        self.rx_tx_turnaround_ns = rx_tx_turnaround_ns
        self.deadline_tolerance_ns = deadline_tolerance_ns
        self.state = RadioState.IDLE
        self.stats = RtSchedulerStats()
        self._heap: list[tuple[int, int, int, RtEvent]] = []
        self._cancelled: set[int] = set()
        self._seq = itertools.count()
        self._state_changed_ns = self.now_ns()

    # ------------------------------------------------------- clock

    def now_ns(self) -> int:
        return self.clock.now_ns()

    # ------------------------------------------------------- state

    def transition(self, target: RadioState):
        """Validated state transition; turnaround states auto-enter on
        TX/RX completion (rt_scheduler.rs:308)."""
        if target not in _VALID_TRANSITIONS[self.state]:
            raise RadioStateError(
                f"invalid transition {self.state.value} -> {target.value}")
        # turnaround timing: leaving a turnaround state requires the
        # configured settle time to have elapsed
        now = self.now_ns()
        if self.state == RadioState.TX_TURNAROUND and \
                target == RadioState.RECEIVING:
            if now - self._state_changed_ns < self.tx_rx_turnaround_ns:
                raise RadioStateError("tx->rx turnaround not elapsed")
        if self.state == RadioState.RX_TURNAROUND and \
                target == RadioState.TRANSMITTING:
            if now - self._state_changed_ns < self.rx_tx_turnaround_ns:
                raise RadioStateError("rx->tx turnaround not elapsed")
        self.state = target
        self._state_changed_ns = now

    # --------------------------------------------------- scheduling

    def schedule(self, event: RtEvent) -> int:
        heapq.heappush(self._heap, (event.deadline_ns, event.priority,
                                    next(self._seq), event))
        return event.id

    def schedule_in(self, delay_ns: int, action: Callable, **kw) -> int:
        return self.schedule(RtEvent(self.now_ns() + delay_ns, action, **kw))

    def cancel(self, event_id: int) -> bool:
        known = any(ev.id == event_id for _, _, _, ev in self._heap)
        if known:
            self._cancelled.add(event_id)
            self.stats.cancelled += 1
        return known

    def cancel_from_source(self, source: str) -> int:
        ids = [ev.id for _, _, _, ev in self._heap
               if ev.source == source and ev.id not in self._cancelled]
        self._cancelled.update(ids)
        self.stats.cancelled += len(ids)
        return len(ids)

    @property
    def pending(self) -> int:
        return sum(1 for _, _, _, ev in self._heap
                   if ev.id not in self._cancelled)

    # ---------------------------------------------------- execution

    def run_pending(self) -> int:
        """Execute all due events in (deadline, priority) order; guarded
        events whose guard fails are dropped and counted. Returns the
        number executed."""
        executed = 0
        now = self.now_ns()
        while self._heap and self._heap[0][0] <= now:
            _, _, _, ev = heapq.heappop(self._heap)
            if ev.id in self._cancelled:
                self._cancelled.discard(ev.id)
                continue
            lateness = now - ev.deadline_ns
            if lateness > self.deadline_tolerance_ns:
                self.stats.missed_deadlines += 1
                self.stats.max_lateness_ns = max(
                    self.stats.max_lateness_ns, lateness)
            if not ev.check_guard(self.state):
                self.stats.guard_blocked += 1
            else:
                ev.action()
                self.stats.executed += 1
                executed += 1
            if ev.repeat_interval_ns:
                heapq.heappush(
                    self._heap,
                    (ev.deadline_ns + ev.repeat_interval_ns, ev.priority,
                     next(self._seq),
                     dataclasses.replace(
                         ev, deadline_ns=ev.deadline_ns
                         + ev.repeat_interval_ns)))
            now = self.now_ns()
        return executed
