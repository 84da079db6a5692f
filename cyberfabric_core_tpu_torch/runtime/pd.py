"""Prefill/decode disaggregated serving pool (the port's copy of
``runtime/pd.py``).

:class:`PDServingPool` splits a replica pool into two role groups.
``n_prefill`` replicas run ``pd_role="prefill"`` engines (mixed-batch
chunked prefill with the radix prefix cache, lookahead and speculation
off: no decode row outlives its first token); ``n_decode`` replicas run
``pd_role="decode"`` engines (the base config's ring and speculation).

- **Handoff.** After a stream's first token the prefill engine exports it
  (its pages to host, its resume record) and calls :meth:`on_handoff`,
  which gives the record to the least-loaded decode engine's
  ``submit_handoff``; that engine imports the pages and decodes on. So a
  decode engine's rounds are all decode rounds, and a prefill storm never
  lands in them.
- **Warm prefixes.** Prefill engines keep their radix trees, and every
  pick that prefills (a fresh request, a failover's re-prefill) probes the
  prefill group's caches only.
- **Failure.** A prefill replica that breaks mid-handoff (the
  ``scheduler.handoff`` failpoint) ends the stream with ``error`` into the
  pool's failover, which re-prefills prompt + emitted tokens on a surviving
  prefill replica; a handoff that finds no decode target does the same.
- **Role flips.** :meth:`flip_role` retags a replica and rebuilds it in the
  new role: inline without a lifecycle manager (in-flight streams fail
  over), through a drain with one. :meth:`rebalance` recommends a flip when
  one side saturates while the other idles.

Devices, params sharing and the lifecycle are the data-parallel pool's
(:mod:`.replicas`).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Optional

from ..modkit.flight_recorder import record_event
from ..modkit.metrics import bump_counter
from .engine import EngineConfig, StepEvent
from .replicas import DataParallelServingPool, pool_devices
from .scheduler import ContinuousBatchingEngine

logger = logging.getLogger("pd")


def _role_config(config: EngineConfig, role: str) -> EngineConfig:
    """A role's engine config from the shared base: prefill engines never
    decode past the first token, so lookahead and speculation are off
    there; decode engines keep the base."""
    if role == "prefill":
        return dataclasses.replace(config, pd_role="prefill", decode_lookahead=0,
                                   scheduler_spec_k=0)
    return dataclasses.replace(config, pd_role="decode")


class PDServingPool(DataParallelServingPool):
    """Prefill-role and decode-role replica groups with page-granularity KV
    handoff, behind the data-parallel pool's submit / cancel / stats."""

    def __init__(self, config: EngineConfig, n_prefill: int, n_decode: int,
                 devices: Optional[list[Any]] = None, seed: int = 0, max_retries: int = 1,
                 lifecycle: Any = None, params: Optional[Any] = None) -> None:
        if n_prefill < 1 or n_decode < 1:
            raise ValueError(f"PD split needs at least one replica per role, got "
                             f"pd_prefill_replicas={n_prefill}, "
                             f"pd_decode_replicas={n_decode}")
        n_total = n_prefill + n_decode
        self.devices = pool_devices(devices, n_total)
        self._init_common(config, seed, max_retries)
        #: successful handoffs, and handoffs that found no decode target
        self.handoffs = 0
        self.handoffs_failed = 0
        #: role tags, index-aligned with ``replicas``; the groups derive from it
        self._roles: list[str] = ["prefill"] * n_prefill + ["decode"] * n_decode
        self._shared = []
        self._given_params = params
        self.replicas: list[ContinuousBatchingEngine] = [
            self.build_replica(i) for i in range(n_total)]
        self._start_lifecycle(lifecycle)
        logger.info("PD serving pool: %d prefill + %d decode replicas over %s (lifecycle %s)",
                    n_prefill, n_decode, [str(d) for d in self.devices],
                    "supervised" if self.lifecycle is not None else "off")

    # ------------------------------------------------------------------ roles
    def _prefill_group(self) -> list[int]:
        return [i for i, r in enumerate(self._roles) if r == "prefill"]

    def _decode_group(self) -> list[int]:
        return [i for i, r in enumerate(self._roles) if r == "decode"]

    def build_replica(self, idx: int) -> ContinuousBatchingEngine:
        """A fresh engine in slot ``idx``'s current role (a pending flip
        lands here), a prefill one wired to the handoff sink; params shared
        as in the data-parallel pool."""
        eng = self._engine(_role_config(self.config, self._roles[idx]), self.devices[idx])
        if self._roles[idx] == "prefill":
            eng._handoff_sink = self.on_handoff
        return eng

    def _pick(self, prompt_ids=None, exclude=(), group=None) -> int:
        """Every pick that prefills (a fresh request, a failover's
        continuation) goes to the prefill group; handoffs pass the decode
        group."""
        if group is None:
            group = self._prefill_group()
        return super()._pick(prompt_ids, exclude=exclude, group=group)

    # ------------------------------------------------------------------ handoff
    def on_handoff(self, rec: Any) -> None:
        """Route a prefill engine's exported stream to a decode engine. Runs
        on the source engine's scheduler thread and never raises: no decode
        target ends the stream with ``error`` through its tracked emit,
        which fails it over (a re-prefill on a survivor)."""
        rid = rec.state.request_id
        with self._lock:
            tracked = self._requests.get(rid)
        old = tracked.replica if tracked is not None else None
        try:
            idx = super()._pick(group=self._decode_group())
            self._note_dispatch(idx)
            try:
                self.replicas[idx].submit_handoff(rec)
            except Exception:
                self._note_departed(idx)
                raise
        except Exception as e:  # noqa: BLE001 — "no healthy replicas" included
            self.handoffs_failed += 1
            logger.warning("handoff of %s found no decode target (%s); failing over to "
                           "re-prefill", rid, e)
            record_event(rid, "error", detail=f"handoff failed: {e}"[:200])
            try:
                rec.state.emit(StepEvent(0, -1, "error"))
            except Exception:  # noqa: BLE001 — the wrapper owns terminals
                pass
            return
        if tracked is not None:
            # terminals and cancels now belong to the decode replica
            tracked.replica = idx
            if old is not None:
                self._note_departed(old)
            if tracked.cancelled:
                try:
                    self.replicas[idx].cancel(rid, "cancelled")
                except Exception:  # noqa: BLE001
                    pass
        self.handoffs += 1
        bump_counter("llm_pd_handoffs_total")

    # ------------------------------------------------------------------ flips
    def flip_role(self, idx: int, role: str,
                  deadline_s: Optional[float] = None) -> dict[str, Any]:
        """Retag replica ``idx`` and rebuild it in ``role``: through a drain
        (and a restart once drained) with a lifecycle manager, inline
        without one. Each role keeps one replica at least."""
        if role not in ("prefill", "decode"):
            raise ValueError(f"role must be 'prefill' or 'decode', got {role!r}")
        if not 0 <= idx < len(self.replicas):
            raise IndexError(f"replica index {idx} out of range")
        if self._roles[idx] == role:
            return {"index": idx, "role": role, "flipped": False}
        if not [i for i, r in enumerate(self._roles) if r == self._roles[idx] and i != idx]:
            raise ValueError(f"cannot flip replica {idx}: it is the last "
                             f"{self._roles[idx]}-role replica")
        old_role = self._roles[idx]
        self._roles[idx] = role
        record_event(f"pd/replica{idx}", "role_flip", replica=idx, from_role=old_role,
                     to_role=role)
        logger.info("PD role flip: replica %d %s -> %s", idx, old_role, role)
        if self.lifecycle is None:
            try:
                self.replicas[idx].close(timeout=5.0)  # in-flight streams fail over
            except Exception:  # noqa: BLE001 — a corpse must not block the flip
                logger.exception("closing replica %d for role flip failed", idx)
            eng = self.build_replica(idx)
            eng.start()
            self.replicas[idx] = eng
            return {"index": idx, "role": role, "flipped": True, "mode": "inline"}
        self.lifecycle.drain(idx, deadline_s)
        threading.Thread(target=self._await_drain_then_restart, args=(idx,),
                         name=f"pd-flip-{idx}", daemon=True).start()
        return {"index": idx, "role": role, "flipped": True, "mode": "drain"}

    def _await_drain_then_restart(self, idx: int) -> None:
        lc = self.lifecycle
        while lc is not None:
            try:
                state = lc.status_row(idx)["state"]
            except Exception:  # noqa: BLE001 — manager stopped mid-flip
                return
            if state == "drained":
                try:
                    lc.restart(idx)
                except Exception:  # noqa: BLE001 — raced an operator action
                    pass
                return
            if state != "draining":
                return  # undrained or crashed: the flip lands at the next rebuild
            time.sleep(0.05)

    def rebalance(self) -> dict[str, Any]:
        """A flip recommendation from the groups' loads (a pure read)."""
        def group_load(group: list[int]) -> float:
            loads = []
            for i in group:
                try:
                    s = self.replicas[i].stats()
                except Exception:  # noqa: BLE001 — a broken one reads as busy
                    loads.append(float(self.config.max_batch))
                    continue
                loads.append(s["active"] + s["pending"] + s.get("prefilling", 0)
                             + s.get("suspended", 0))
            return sum(loads) / max(1, len(loads))

        pg, dg = self._prefill_group(), self._decode_group()
        p_load, d_load = group_load(pg), group_load(dg)
        cap = float(self.config.max_batch)
        rec: Optional[dict[str, Any]] = None
        if p_load >= cap and d_load < cap / 2 and len(dg) > 1:
            rec = {"flip": min(dg), "to_role": "prefill"}
        elif d_load >= cap and p_load < cap / 2 and len(pg) > 1:
            rec = {"flip": min(pg), "to_role": "decode"}
        return {"prefill_load": round(p_load, 2), "decode_load": round(d_load, 2),
                "recommendation": rec}

    def stats(self) -> dict[str, Any]:
        out = super().stats()
        out["pd"] = {"roles": list(self._roles), "prefill_replicas": self._prefill_group(),
                     "decode_replicas": self._decode_group(), "handoffs": self.handoffs,
                     "handoffs_failed": self.handoffs_failed,
                     "rebalance": self.rebalance()}
        return out
