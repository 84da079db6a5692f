"""The paged decode chunk as one device program (counterpart of the JAX
scheduler's ``_build_programs`` ``paged_decode_chunk`` and of
``runtime/aot_tpu.py serving_programs``, which compile it ahead of time).

JAX compiles the chunk's ``decode_chunk`` steps (a ``lax.scan`` over the
paged decode forward, the LM head, sampling and device-side termination)
into one program per shape. Enqueued eagerly, the port's chunk is several
thousand launches, whose host enqueue takes far longer than the card takes
to run them. On CUDA, :class:`PagedDecodeChunk` captures the chunk once per
(``max_batch``, ``decode_chunk``, greedy or sampling) as a CUDA graph and
replays it; on the CPU it calls the same body eagerly.

The body is a function of static buffers: the chunk's inputs (last tokens,
lengths, finished and active masks, the sampling uniforms) are copied into
buffers of this object before each run, and its outputs are written into
buffers of this object and cloned out before the next run can overwrite
them. Everything else it reads (weights, KV pools, page table, stop rows,
limits, temperature / top-p / top-k rows, rope tables) is the engine's own
tensor, updated in place and never rebound while this object lives.

Randomness stays outside the program: before each run, every sampling
slot's ``decode_chunk`` uniforms are drawn from its own ``torch.Generator``
into a static ``[k, max_batch]`` buffer, one ``uniform_`` of one element
per step, in step order. That is what the k ``torch.rand(1)`` calls of an
eager chunk drew, so each stream advances by a run exactly as it did, and
the lookahead ring's generator restore keeps streams equal at every depth.
The generators are not registered with the graph: a slot's generator
changes at each admission.

Under tensor parallelism the body runs every rank's forward
(:mod:`..models.llama` with a ``ShardedLlama``): when the ranks share one
card, one capture holds all of them. The engine captures nothing when the
ranks span several cards (capture across cards is unverified) and runs the
chunk eagerly there; ``stats()["pipeline"]`` says which.

Capture happens once, in the constructor (the engine's start, on whichever
thread builds the engine), never inside a round: two warm-up runs of each
body on a side stream with every row inactive (their KV writes land on
scratch page 0), then one capture per body into one shared memory pool. A capture that fails raises. The kernel
wrappers' ``launches`` counts move by replay: the launches recorded while
capturing, added once per replay.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..models import llama
from ..models.configs import ModelConfig
from ..ops import flash_attention as fa
from ..ops import paged_attention as pa
from ..ops.sampling import sample_token_per_slot

#: the kernel wrappers whose launch counts a replay moves
_WRAPPERS = (pa.ragged_paged_attention, pa.paged_decode_attention, fa.flash_self_attention)


class PagedDecodeChunk:
    """``k_steps`` fused paged decode steps over ``n_slots`` rows.

    ``rows`` are the engine's per-slot device rows the chunk reads:
    ``page_table`` [n, Pmax] int32, ``stops`` [n, W] int32, ``limit`` [n]
    int32, ``temperature`` / ``top_p`` [n] f32, ``top_k`` [n] int32. With
    ``graphs`` (CUDA only) the two bodies are captured here."""

    def __init__(self, params: llama.LlamaModel, cfg: ModelConfig,
                 pools: llama.PagedPools, rows: dict[str, torch.Tensor],
                 rope_tables: tuple[torch.Tensor, torch.Tensor], n_slots: int,
                 k_steps: int, max_seq_len: int, graphs: bool) -> None:
        # under tp the pools are lists, one tensor a rank: the chunk's own
        # buffers live on rank 0's device
        dev = (pools[0][0] if isinstance(pools[0], list) else pools[0]).device
        if graphs and dev.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, the pools are on {dev}")
        self.params, self.cfg, self.pools, self.rows = params, cfg, pools, rows
        self.rope_tables = rope_tables
        self.k, self.max_seq_len = k_steps, max_seq_len
        n = n_slots
        i32 = dict(dtype=torch.int32, device=dev)
        # inputs
        self.toks = torch.zeros(n, **i32)
        self.lengths = torch.zeros(n, **i32)
        self.finished = torch.ones(n, dtype=torch.bool, device=dev)
        self.active = torch.zeros(n, dtype=torch.bool, device=dev)
        self.uniforms = torch.zeros((k_steps, n), dtype=torch.float32, device=dev)
        # outputs
        self.out_chunk = torch.zeros((n, k_steps), **i32)
        self.out_last = torch.zeros(n, **i32)
        self.out_lengths = torch.zeros(n, **i32)
        self.out_finished = torch.zeros(n, dtype=torch.bool, device=dev)
        #: all_greedy → the captured graph, and the launches it records
        self._graphs: dict[bool, torch.cuda.CUDAGraph] = {}
        self._graph_launches: dict[bool, list[tuple]] = {}
        self.replays = 0
        self.eager_runs = 0
        if graphs:
            self._capture()

    @property
    def graphs(self) -> bool:
        return bool(self._graphs)

    def _body(self, all_greedy: bool) -> None:
        """The chunk on the static buffers: rows that hit a stop id, their
        limit or (at the last step) the window bound freeze, emit -1, and
        stop advancing; their KV writes go to scratch page 0."""
        r, k = self.rows, self.k
        toks, lens, fin, active = self.toks, self.lengths, self.finished, self.active
        emits = []
        for j in range(k):
            run = active & ~fin
            hidden, _ = llama.forward_paged_decode(
                self.params, self.cfg, toks[:, None], self.pools, r["page_table"], lens,
                self.rope_tables, write_mask=run)
            logits = llama.lm_head_logits(self.params, self.cfg, hidden[:, 0])
            if all_greedy:
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                nxt = sample_token_per_slot(logits, self.uniforms[j], r["temperature"],
                                            r["top_p"], r["top_k"], all_greedy=False)
            new_lens = lens + 1
            is_stop = (nxt[:, None] == r["stops"]).any(dim=1)
            hit = new_lens >= r["limit"]
            if j == k - 1:
                hit = hit | (new_lens + k > self.max_seq_len)
            emits.append(torch.where(run, nxt, torch.full_like(nxt, -1)))
            toks = torch.where(run, nxt, toks)
            lens = torch.where(run, new_lens, lens)
            fin = fin | (run & (is_stop | hit))
        self.out_chunk.copy_(torch.stack(emits, dim=1))
        self.out_last.copy_(toks)
        self.out_lengths.copy_(torch.where(active, lens, torch.zeros_like(lens)))
        self.out_finished.copy_(fin)

    def _capture(self) -> None:
        # every row inactive: the warm-up runs write KV only to scratch page 0
        self.active.zero_()
        self.finished.fill_(True)
        side = torch.cuda.Stream(self.toks.device)
        side.wait_stream(torch.cuda.current_stream(self.toks.device))
        with torch.inference_mode(), torch.cuda.stream(side):
            for all_greedy in (True, False):
                for _ in range(2):
                    self._body(all_greedy)
        torch.cuda.current_stream(self.toks.device).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        for all_greedy in (True, False):
            before = [w.launches for w in _WRAPPERS]
            graph = torch.cuda.CUDAGraph()
            # thread_local: the worker builds an engine on an executor thread
            # while other engines' scheduler threads keep running; the
            # default (global) capture mode would fail their CUDA calls
            with torch.inference_mode(), torch.cuda.graph(
                    graph, pool=pool, capture_error_mode="thread_local"):
                self._body(all_greedy)
            self._graph_launches[all_greedy] = [
                (w, w.launches - b) for w, b in zip(_WRAPPERS, before)]
            for w, b in zip(_WRAPPERS, before):  # capturing launched nothing
                w.launches = b
            self._graphs[all_greedy] = graph

    def _draw(self, generators: Sequence[Optional[torch.Generator]]) -> None:
        """Each sampling slot's k uniforms, in step order, from its own
        generator (rows without one get 0)."""
        self.uniforms.zero_()
        for i, g in enumerate(generators):
            if g is not None:
                for j in range(self.k):
                    self.uniforms[j, i:i + 1].uniform_(generator=g)

    def __call__(self, toks: torch.Tensor, lengths: torch.Tensor, finished: torch.Tensor,
                 active: torch.Tensor, generators: Sequence[Optional[torch.Generator]],
                 all_greedy: bool) -> tuple[torch.Tensor, ...]:
        """Enqueue one chunk from these inputs: returns new tensors (tokens
        [n, k] with -1 for frozen rows, last tokens, lengths with inactive
        rows at 0, finished mask). ``generators``: each row's, None where
        the row does not draw. Nothing synchronises with the device."""
        self.toks.copy_(toks)
        self.lengths.copy_(lengths)
        self.finished.copy_(finished)
        self.active.copy_(active)
        if not all_greedy:
            self._draw(generators)
        graph = self._graphs.get(all_greedy)
        if graph is None:
            self._body(all_greedy)
            self.eager_runs += 1
        else:
            graph.replay()
            for wrapper, n in self._graph_launches[all_greedy]:
                wrapper.launches += n
            self.replays += 1
        return (self.out_chunk.clone(), self.out_last.clone(), self.out_lengths.clone(),
                self.out_finished.clone())
