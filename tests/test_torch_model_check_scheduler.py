"""Admission invariants of the port's engine, audited after every step.

Mirrors ``tests/test_model_check_scheduler.py``: the engine is driven
synchronously (no scheduler thread) through churn, injected pool pressure
(preemption to host and resume) and seeded random walks, with cancels mixed
into the walks, and invariants A1–A7 of the JAX test are checked after
every admission and every round:

  A1 slot/state     empty slot ⇔ inactive ∧ untracked; an occupied slot is
                    decode-phase (active) or prefill-phase (inactive, in
                    the prefill queue)
  A2 table hygiene  empty slots have all-zero page-table rows
  A3 chain/table    page_table[i, :len(chain)] == chain, zeros after; the
                    chain covers the slot's tokens; no duplicates
  A4 ref coverage   a page in k live chains has refcount ≥ k
  A5 chunk room     active slots satisfy lengths[i] + k ≤ max_seq
  A6 suspension     suspended records hold host KV covering their length
  A7 pool audit     conservation, orphans and refs of the pool
"""

from __future__ import annotations

import numpy as np
import pytest

from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, SamplingParams
from cyberfabric_core_tpu_torch.runtime.scheduler import ContinuousBatchingEngine


def _make_engine(slots: int = 2, max_seq: int = 64, mixed: bool = True, depth: int = 2):
    cfg = EngineConfig(model="tiny-llama", max_seq_len=max_seq, max_batch=slots,
                       decode_chunk=4, use_flash=False, prefix_cache_pages=1,
                       prefix_page_size=16, mixed_batch=mixed, dtype="float32",
                       decode_lookahead=depth)
    eng = ContinuousBatchingEngine(cfg, seed=0, device="cpu")
    eng.start = lambda: None  # driven synchronously: no scheduler thread
    return eng


class Harness:
    def __init__(self, eng: ContinuousBatchingEngine) -> None:
        self.eng = eng
        self.finished: dict[str, list[str]] = {}
        self.tokens: dict[str, int] = {}
        self._n = 0

    def submit(self, prompt: list[int], max_tokens: int, seed: int = 7,
               temperature: float = 0.0) -> str:
        self._n += 1
        rid = f"mc-{self._n}"

        def emit(ev):
            if ev.token_id >= 0:
                self.tokens[rid] = self.tokens.get(rid, 0) + 1
            if ev.finished:
                self.finished.setdefault(rid, []).append(ev.finished)

        self.eng.submit(prompt, SamplingParams(max_tokens=max_tokens, seed=seed,
                                               temperature=temperature), emit,
                        request_id=rid)
        return rid

    def audit(self, ctx: str) -> None:
        eng, pool, k = self.eng, self.eng.pool, self.eng._k_steps
        prefilling = set(eng._prefill_slots)
        for i in range(eng.n_slots):
            state = eng.slots[i]
            if state is None:
                assert not eng.active[i] and i not in prefilling, f"A1 slot {i} {ctx}"
                assert not eng.page_table[i].any(), f"A2 row {i} {ctx}"
                continue
            if state.phase == "prefill":
                assert not eng.active[i] and i in prefilling, f"A1 prefill {i} {ctx}"
                covered = state.prefill_pos
                assert int(eng.lengths[i]) == 0, f"A5 prefill {i} {ctx}"
            else:
                assert eng.active[i] and i not in prefilling, f"A1 decode {i} {ctx}"
                covered = int(eng.lengths[i])
                assert covered + k <= eng.config.max_seq_len, f"A5 slot {i} {ctx}"
            chain = state.chain
            assert len(set(chain)) == len(chain), f"A3 dup {chain} {ctx}"
            assert list(eng.page_table[i, :len(chain)]) == chain, f"A3 table {i} {ctx}"
            assert not eng.page_table[i, len(chain):].any(), f"A3 trailing {i} {ctx}"
            assert pool.pages_for(covered) <= len(chain), f"A3 short {i} {ctx}"
        users: dict[int, int] = {}
        for st in eng.slots:
            for p in (st.chain if st is not None else ()):
                users[p] = users.get(p, 0) + 1
        for p, n in users.items():
            assert pool._refs.get(p, 0) >= n, f"A4 page {p} {ctx}"
        for rec in eng._suspended:
            need = pool.pages_for(rec.length)
            if rec.state.phase == "prefill":
                assert rec.host_kv[0].shape[1] >= need, f"A6 prefill {ctx}"
            else:
                assert rec.host_kv[0].shape[1] == need, f"A6 decode {ctx}"
        tracked = set(pool._tree_owned) | set(pool._orphans) | set(pool._refs)
        assert pool.capacity_pages - pool.allocator.num_free == len(tracked), f"A7 {ctx}"
        assert not (pool._orphans & pool._tree_owned), f"A7 orphans {ctx}"
        assert all(c >= 1 for c in pool._refs.values()), f"A7 refs {ctx}"

    def step(self, ctx: str) -> None:
        self.eng._service_cancellations()
        self.eng._service_tenant_caps()
        self.eng._admit()
        self.audit(f"{ctx}/post-admit")
        if self.eng.active.any() or self.eng._prefill_slots:
            self.eng._decode_round()
            self.audit(f"{ctx}/post-round")

    def one_terminal_each(self) -> None:
        assert all(len(f) == 1 for f in self.finished.values()), self.finished


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "phase-separated"])
def test_churn_schedule_holds_invariants(mixed):
    eng = _make_engine(mixed=mixed)
    h = Harness(eng)
    prompts = [list(range(10, 10 + n)) for n in (5, 9, 17, 7, 12)]
    for i, p in enumerate(prompts):
        h.submit(p, max_tokens=6 + i)
    for step in range(40):
        h.step(f"churn{step}")
        if len(h.finished) == len(prompts):
            break
    assert len(h.finished) == len(prompts), h.finished
    assert all(f[0] in ("stop", "length") for f in h.finished.values())
    h.one_terminal_each()


def test_preemption_pressure_holds_invariants():
    """Injected MemoryErrors from extend_chain force preemptions mid-decode
    (the pool is sized so real pressure never comes); the suspended
    requests resume and finish with every invariant intact."""
    eng = _make_engine()
    h = Harness(eng)
    orig, faults = eng.pool.extend_chain, {"armed": 0}

    def flaky(chain, needed):
        if faults["armed"] and eng.preemptions < 2 and len(chain) >= 2:
            raise MemoryError("injected pool pressure")
        return orig(chain, needed)

    eng.pool.extend_chain = flaky
    shared = list(range(1, 18))  # two pages: prefix sharing is live
    h.submit(shared + [30], max_tokens=40)
    h.submit(shared + [31], max_tokens=40, temperature=0.8)
    h.submit(list(range(40, 57)), max_tokens=30)
    for step in range(80):
        faults["armed"] = step >= 3
        h.step(f"pressure{step}")
        if len(h.finished) == 3:
            break
    assert len(h.finished) == 3 and eng.preemptions >= 1, (h.finished, eng.preemptions)
    assert all(f == ["length"] for f in h.finished.values()), h.finished
    h.one_terminal_each()


@pytest.mark.parametrize("walk_seed", [11, 23, 37])
def test_random_walks_hold_invariants(walk_seed):
    """Seeded interleavings of submit, cancel and step (sampled and greedy
    requests, ring depth 2): every step audited, one terminal a stream."""
    rng = np.random.default_rng(walk_seed)
    eng = _make_engine()
    h = Harness(eng)
    submitted = []
    for step in range(60):
        if len(submitted) < 6 and rng.random() < 0.4:
            n, base = int(rng.integers(3, 20)), int(rng.integers(1, 200))
            submitted.append(h.submit([base + j for j in range(n)],
                                      max_tokens=int(rng.integers(2, 12)),
                                      seed=int(rng.integers(0, 1000)),
                                      temperature=float(rng.choice([0.0, 0.8]))))
        if submitted and rng.random() < 0.15:
            eng.cancel(str(rng.choice(submitted)), "walk")
        h.step(f"walk{walk_seed}.{step}")
        if len(submitted) >= 6 and len(h.finished) == len(submitted):
            break
    assert len(h.finished) == len(submitted)
    assert sum(h.tokens.values()) > 0
    h.one_terminal_each()
