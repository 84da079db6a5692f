"""Data-parallel serving pool: one ``submit`` in front of N replicas (the
port's copy of ``runtime/replicas.py``).

Each replica is a whole :class:`.scheduler.ContinuousBatchingEngine` (its
own KV pool, scheduler thread and, on CUDA, decode graphs, captured on the
thread that builds it) pinned to a device. ``devices`` defaults to the
visible CUDA cards, and ``n_replicas`` past their number raises, as JAX's
pool does over ``jax.devices()``; an explicit list may name a device more
than once (``["cpu"] * n`` in the CPU tests, ``[cuda:0, cuda:0]`` on one
card). Replicas on one device share one params tree, with no copy, and a
rebuild reuses it: with ``params=None`` the first replica on a device draws
the seeded weights (quantized when the config says so) and the others take
them; a tree passed in is placed once per device.

Routing (:meth:`DataParallelServingPool._pick`): the least-loaded
admittable replica (active + pending + prefilling), unless another
replica's prefix cache already holds the prompt's head and its load is
within ``cache_affinity_slack`` of the least; a lifecycle manager's
non-admitting states are skipped and probation replicas capped at their
canary budget. Failover: when a replica ends a stream with ``error`` (its
loop broke, or it was closed), the pool resubmits prompt + emitted tokens
with the remaining budget on another replica, excluding the one that broke,
with seeded jittered backoff between attempts, so a greedy client stream
goes on token for token; a stream whose budget was already served gets a
synthesized ``length`` terminal instead. A cancelled request is never
resubmitted.

Failovers, synthesized terminals and lapses land in the flight recorder
under the request's id (``failover`` reopens the closed record), and the
``llm_replica_failovers_total`` / ``llm_cache_aware_placements_total``
counters in the metrics registry, as in JAX; :meth:`stats` keeps the same
counts.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Optional

import torch

from ..device import resolve_device, same_device
from ..models.configs import get_config
from ..modkit.failpoints import failpoint, record_recovery
from ..modkit.flight_recorder import record_event
from ..modkit.metrics import bump_counter
from .engine import EngineConfig, SamplingParams, StepEvent
from .lifecycle import LifecycleConfig, ReplicaLifecycleManager
from .quant import is_quantized, quant_bits, quantize_llama_params
from .scheduler import ContinuousBatchingEngine
from .weights import model_from_state_dict, params_on

logger = logging.getLogger("replicas")


def pool_devices(devices: Optional[list[Any]], n: int) -> list[torch.device]:
    """The first ``n`` of ``devices`` (default: every visible CUDA card,
    raising without one), as devices; fewer than ``n`` raises."""
    if devices is None:
        resolve_device(None)  # no card: raises, naming device='cpu'
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if n > len(devices):
        raise ValueError(f"{n} replicas need {n} devices, have {len(devices)}")
    return [resolve_device(d) for d in devices[:n]]


@dataclass
class _Tracked:
    """Host-side record of a request, for failover resubmission."""
    prompt_ids: list[int]
    sampling: SamplingParams
    emit: Callable[[StepEvent], None]
    emitted: list[int]
    replica: int
    retries_left: int
    done: bool = False
    trace: Optional[str] = None
    #: set by cancel(): never resubmitted; an error terminal after the mark
    #: surfaces as ``cancelled``
    cancelled: bool = False
    #: absolute monotonic deadline, carried across failover
    deadline: Optional[float] = None
    tenant: Optional[str] = None


class DataParallelServingPool:
    """N continuous-batching replicas behind one submit()."""

    #: class defaults, so stats() and _pick work on bare instances
    placement_hint_hits = 0
    cache_affinity_slack = 1
    synthesized_terminals = 0
    #: set by close(): errors from retiring replicas are not failed over
    _closing = False
    #: None: a broken replica stays broken; ``lifecycle=True`` or a
    #: LifecycleConfig makes the pool self-healing
    lifecycle: Optional[ReplicaLifecycleManager] = None
    #: failover resubmission attempts and their jittered backoff
    failover_retries = 2
    failover_backoff_s = 0.05
    failover_backoff_max_s = 0.5
    _failover_rng = random.Random(0)

    def __init__(self, config: EngineConfig, n_replicas: int,
                 devices: Optional[list[Any]] = None, seed: int = 0, max_retries: int = 1,
                 lifecycle: Any = None, params: Optional[Any] = None) -> None:
        self.devices = pool_devices(devices, n_replicas)
        self._init_common(config, seed, max_retries)
        self._shared: list[tuple[torch.device, Any]] = []
        self._given_params = params
        self.replicas: list[ContinuousBatchingEngine] = [
            self._engine(config, dev) for dev in self.devices]
        self._start_lifecycle(lifecycle)
        logger.info("serving pool: %d replicas over %s (lifecycle %s)", n_replicas,
                    [str(d) for d in self.devices],
                    "supervised" if self.lifecycle is not None else "off")

    def _init_common(self, config: EngineConfig, seed: int, max_retries: int) -> None:
        self.config = config
        self.max_retries = max_retries
        self._seed = seed
        self._failover_rng = random.Random(seed ^ 0xFA17)
        self._lock = threading.Lock()
        self._requests: dict[str, _Tracked] = {}
        self.failovers = 0         # successful mid-stream resubmissions
        self.failovers_failed = 0  # failovers that found no replica
        self.synthesized_terminals = 0
        #: requests placed on the replica whose prefix cache held their head
        self.placement_hint_hits = 0
        self.cache_affinity_slack = max(1, config.max_batch // 2)

    def _start_lifecycle(self, lifecycle: Any) -> None:
        if lifecycle:
            lc_cfg = LifecycleConfig.from_config(lifecycle)
            if lc_cfg.enabled:
                self.lifecycle = ReplicaLifecycleManager(self, lc_cfg)
                self.lifecycle.start()

    # ------------------------------------------------------------ params
    def _params_for(self, config: EngineConfig, dev: torch.device) -> Optional[Any]:
        """The params tree replicas on ``dev`` share: a tree already placed
        there, else the given tree placed once (and quantized once if the
        config quantizes), else None (the first engine draws it)."""
        for have, params in self._shared:
            if same_device(have, dev):
                return params
        given = self._given_params
        if given is None:
            return None
        cfg = get_config(config.model)
        if isinstance(given, Mapping):
            params = model_from_state_dict(given, cfg, dev, getattr(torch, config.dtype))
        else:
            params = params_on(given, dev)
        bits = quant_bits(config.quantization)
        if bits is not None and not is_quantized(params):
            params = quantize_llama_params(params, bits)
        self._shared.append((dev, params))
        return params

    def _engine(self, config: EngineConfig, dev: torch.device) -> ContinuousBatchingEngine:
        eng = ContinuousBatchingEngine(config, params=self._params_for(config, dev),
                                       seed=self._seed, device=dev)
        if not any(same_device(have, dev) for have, _ in self._shared):
            self._shared.append((dev, eng.params))
        return eng

    def build_replica(self, idx: int) -> ContinuousBatchingEngine:
        """A fresh engine for slot ``idx`` on its device, from the shared
        params (a rebuild costs a scheduler start and a graph capture, never
        a weight load). The lifecycle manager commits it."""
        return self._engine(self.config, self.devices[idx])

    # ------------------------------------------------------------ routing
    def _healthy(self) -> list[int]:
        return [i for i, r in enumerate(self.replicas)
                if (s := r.stats())["broken"] is None and not s.get("closed")]

    def _pick(self, prompt_ids: Optional[list[int]] = None, exclude: tuple[int, ...] = (),
              group: Optional[list[int]] = None) -> int:
        """Least-loaded admittable replica (of ``group``, default all),
        ``exclude`` left out by decree; a warm prefix cache wins within
        ``cache_affinity_slack`` of the least load. A probation replica with
        canary budget gets a half-load head start, so an idle one wins
        ties."""
        best, best_eff = None, None
        loads: dict[int, int] = {}
        lc = self.lifecycle
        for i in (range(len(self.replicas)) if group is None else group):
            if i in exclude:
                continue
            s = self.replicas[i].stats()
            if s["broken"] is not None or s.get("closed"):
                continue
            if lc is not None and not lc.admit_allowed(i):
                continue
            loads[i] = s["active"] + s["pending"] + s.get("prefilling", 0)
            eff = loads[i] - (0.5 if lc is not None and lc.canary_wanted(i) else 0.0)
            if best_eff is None or eff < best_eff:
                best, best_eff = i, eff
        if best is None:
            raise RuntimeError("no healthy replicas")
        best_load = loads[best]
        if prompt_ids and len(loads) > 1:
            hint, hint_len = None, 0
            for i in loads:
                pool = getattr(self.replicas[i], "pool", None)
                if pool is None:
                    continue
                try:
                    n = pool.peek_prefix_len(list(prompt_ids))
                except Exception:  # noqa: BLE001 — a probe must never fail a route
                    n = 0
                if n > hint_len:
                    hint, hint_len = i, n
            if hint is not None and hint != best \
                    and loads[hint] - best_load <= self.cache_affinity_slack:
                self.placement_hint_hits += 1
                bump_counter("llm_cache_aware_placements_total")
                return hint
            if hint is not None and hint == best and hint_len > 0:
                self.placement_hint_hits += 1
                bump_counter("llm_cache_aware_placements_total")
        return best

    def submit(self, prompt_ids: list[int], sampling: SamplingParams,
               emit: Callable[[StepEvent], None], request_id: Optional[str] = None,
               trace: Optional[str] = None, deadline: Optional[float] = None,
               tenant: Optional[str] = None) -> str:
        failpoint("replicas.submit")  # an armed raise rejects before any replica
        rid = request_id or f"req-{uuid.uuid4().hex[:16]}"
        broke: tuple[int, ...] = ()
        while True:
            idx = self._pick(prompt_ids, exclude=broke)
            tracked = _Tracked(list(prompt_ids), sampling, emit, [], idx, self.max_retries,
                               trace=trace, deadline=deadline, tenant=tenant)
            # registered BEFORE the submit: the replica may finish the request
            # before this thread returns
            with self._lock:
                self._requests[rid] = tracked
            self._note_dispatch(idx)
            try:
                self.replicas[idx].submit(prompt_ids, sampling, self._wrap(rid, tracked),
                                          rid, **self._submit_extras(tracked))
                return rid
            except Exception as e:
                self._note_departed(idx)
                with self._lock:
                    self._requests.pop(rid, None)
                st = self.replicas[idx].stats()
                if not isinstance(e, RuntimeError) or not (st["broken"] or st.get("closed")):
                    raise
                # the replica broke between the pick and its submit: pick again
                broke += (idx,)

    @staticmethod
    def _submit_extras(tracked: _Tracked) -> dict[str, Any]:
        extras: dict[str, Any] = {"trace": tracked.trace}
        if tracked.deadline is not None:
            extras["deadline"] = tracked.deadline
        if tracked.tenant is not None:
            extras["tenant"] = tracked.tenant
        return extras

    def cancel(self, request_id: str, reason: str = "cancelled") -> bool:
        """Mark the request (so failover never resubmits it) and forward the
        cancel to its replica. Never raises; False for an unknown id."""
        with self._lock:
            tracked = self._requests.get(request_id)
            if tracked is None:
                return False
            tracked.cancelled = True
            idx = tracked.replica
        try:
            self.replicas[idx].cancel(request_id, reason)
        except Exception:  # noqa: BLE001 — a breaking replica's teardown emits error
            pass
        return True

    # ------------------------------------------------- lifecycle notifications
    def _note_dispatch(self, idx: int) -> None:
        if self.lifecycle is not None:
            try:
                self.lifecycle.note_dispatch(idx)
            except Exception:  # noqa: BLE001 — supervision must not break serving
                pass

    def _note_departed(self, idx: int) -> None:
        if self.lifecycle is not None:
            try:
                self.lifecycle.on_departed(idx)
            except Exception:  # noqa: BLE001
                pass

    def _note_terminal(self, idx: int, ok: bool) -> None:
        if self.lifecycle is not None:
            try:
                self.lifecycle.on_terminal(idx, ok)
            except Exception:  # noqa: BLE001
                pass

    def _close_tracked(self, rid: str, tracked: _Tracked) -> None:
        tracked.done = True
        with self._lock:
            self._requests.pop(rid, None)

    def _wrap(self, rid: str, tracked: _Tracked) -> Callable[[StepEvent], None]:
        """The replica's emit, tracked: progress recorded, an error failed
        over, the record dropped at the terminal."""

        def emit(ev: StepEvent) -> None:
            if ev.finished == "error" and tracked.cancelled and not tracked.done:
                # a cancel raced a break: never resubmit; the replica did
                # break, so no clean canary is credited
                self._close_tracked(rid, tracked)
                self._note_departed(tracked.replica)
                tracked.emit(StepEvent(0, -1, "cancelled"))
                return
            if ev.finished == "error" and tracked.retries_left > 0 and not tracked.done \
                    and not self._closing:
                tracked.retries_left -= 1
                if self._failover(rid, tracked):
                    return  # resubmitted, or closed cleanly
            if ev.token_id >= 0:
                tracked.emitted.append(ev.token_id)
            if ev.finished is not None:
                self._close_tracked(rid, tracked)
                self._note_terminal(tracked.replica, ev.finished != "error")
            tracked.emit(ev)

        return emit

    def _failover(self, rid: str, tracked: _Tracked) -> bool:
        """Resubmit on another replica, carrying the emitted tokens as prompt
        continuation; True when the client's stream is taken care of
        (resubmitted, or closed with a synthesized terminal)."""
        t0 = time.monotonic()
        old = tracked.replica
        if tracked.deadline is not None and time.monotonic() >= tracked.deadline:
            self._close_tracked(rid, tracked)
            record_event(rid, "deadline_exceeded", reason="deadline",
                         phase="failover", tokens=len(tracked.emitted))
            self._note_departed(old)
            tracked.emit(StepEvent(0, -1, "deadline"))
            return True
        remaining = tracked.sampling.max_tokens - len(tracked.emitted)
        if remaining <= 0:
            # the replica died after the whole budget was emitted: only the
            # terminal was lost. Release the canary slot without credit; the
            # timeline reads error → failover (synthesized) → finished
            self._close_tracked(rid, tracked)
            self.synthesized_terminals += 1
            record_event(rid, "failover", from_replica=old, to_replica=None,
                         tokens_carried=len(tracked.emitted),
                         synthesized_terminal=True)
            record_event(rid, "finished", reason="length",
                         tokens=len(tracked.emitted), synthesized=True)
            self._note_departed(old)
            tracked.emit(StepEvent(0, -1, "length"))
            return True
        cont_prompt = tracked.prompt_ids + tracked.emitted
        cont_sampling = dataclasses.replace(tracked.sampling, max_tokens=remaining)
        delay = self.failover_backoff_s
        for attempt in range(1 + max(0, self.failover_retries)):
            if attempt:
                time.sleep(delay * (0.5 + self._failover_rng.random()))
                delay = min(delay * 2.0, self.failover_backoff_max_s)
            if tracked.cancelled:
                self._close_tracked(rid, tracked)
                record_event(rid, "cancelled", reason="cancelled",
                             phase="failover", tokens=len(tracked.emitted))
                self._note_departed(old)
                tracked.emit(StepEvent(0, -1, "cancelled"))
                return True
            try:
                failpoint("replicas.failover")
                idx = self._pick(cont_prompt, exclude=(old,))
            except Exception:  # noqa: BLE001 — injected faults included: retry
                continue
            self._note_dispatch(idx)
            logger.warning("failover: replica %d broke; resuming request on %d (attempt %d, "
                           "%d tokens emitted, %d budget left)", old, idx, attempt + 1,
                           len(tracked.emitted), remaining)
            # the same request id: the timeline reads error → failover →
            # enqueued (attempt 2) as one story
            record_event(rid, "failover", from_replica=old, to_replica=idx,
                         tokens_carried=len(tracked.emitted))
            try:
                self.replicas[idx].submit(cont_prompt, cont_sampling, self._wrap(rid, tracked),
                                          rid, **self._submit_extras(tracked))
            except Exception:  # noqa: BLE001 — retry, then the error event
                logger.exception("failover resubmission failed")
                self._note_departed(idx)
                continue
            tracked.replica = idx
            if tracked.cancelled:
                # the cancel went to the old replica; the request lives here now
                try:
                    self.replicas[idx].cancel(rid, "cancelled")
                except Exception:  # noqa: BLE001
                    pass
            self._note_departed(old)
            self.failovers += 1
            record_recovery("replicas.failover", time.monotonic() - t0)
            bump_counter("llm_replica_failovers_total")
            return True
        self.failovers_failed += 1
        return False

    # ------------------------------------------------------------ admin
    def in_flight(self) -> int:
        """Requests the replicas hold (0: the pool may close with no stream
        ended)."""
        return sum(r.in_flight() for r in self.replicas)

    def stats(self) -> dict[str, Any]:
        per = [r.stats() for r in self.replicas]
        return {
            "replicas": len(self.replicas),
            "healthy": len(self._healthy()),
            "failovers": self.failovers,
            "failovers_failed": self.failovers_failed,
            "synthesized_terminals": self.synthesized_terminals,
            "placement_hint_hits": self.placement_hint_hits,
            "active": sum(s["active"] for s in per),
            "pending": sum(s["pending"] for s in per),
            "tokens_emitted": sum(s["tokens_emitted"] for s in per),
            "requests_completed": sum(s["requests_completed"] for s in per),
            "per_replica": per,
            "lifecycle": self.lifecycle.status() if self.lifecycle is not None else None,
        }

    def shutdown(self, timeout: float = 10.0) -> None:
        if self.lifecycle is not None:
            self.lifecycle.stop()  # the supervisor must not rebuild corpses
        for r in self.replicas:
            r.shutdown(timeout)

    def close(self, timeout: float = 10.0) -> None:
        """Retire every replica, ending what is in flight with ``error``
        (never failed over)."""
        self._closing = True
        if self.lifecycle is not None:
            self.lifecycle.stop()
        for r in self.replicas:
            r.close(timeout)
