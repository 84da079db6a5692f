"""Prompt-lookup drafting and greedy acceptance for the continuous
scheduler's speculative rounds (counterpart of the parts of
``runtime/speculative.py`` the scheduler uses).

- :class:`NgramProposer` drafts from a stream's own history: the tail
  n-gram (longest n first) is looked up where it occurred before, and the
  tokens that followed it there are proposed. Host-side, no device work.
- :func:`greedy_accept_counts` is the device-side accept of a verify span:
  the number of leading drafts equal to the model's own argmax
  continuation. :func:`accept_length` is its host twin.

The lockstep engine's draft model and its verify programs are a later
slice of the port (ROADMAP queue 1 item 7)."""

from __future__ import annotations

from typing import Optional

import torch


class NgramProposer:
    """Incremental n-gram index over one sequence's tokens.

    For each n in [min_n, max_n], remembers the position right after the most
    recent occurrence of every n-gram. ``propose`` matches the current tail
    n-gram (longest n first) and copies up to k tokens that followed its
    previous occurrence."""

    def __init__(self, max_n: int = 3, min_n: int = 1, k: int = 8) -> None:
        if not 1 <= min_n <= max_n:
            raise ValueError(f"bad n-gram range [{min_n}, {max_n}]")
        self.max_n = max_n
        self.min_n = min_n
        self.k = k
        self.tokens: list[int] = []
        #: ngram -> (end of latest occurrence, end of previous occurrence).
        #: The sequence tail is always its own latest occurrence, so
        #: propose() reads the previous one.
        self._index: dict[tuple[int, ...], tuple[int, Optional[int]]] = {}
        #: propose() memo keyed by the sequence length it was computed at:
        #: the scheduler probes several times a round against one tail
        self._memo: tuple[int, Optional[list[int]]] = (-1, None)

    def extend(self, tokens: list[int]) -> None:
        for tok in tokens:
            self.tokens.append(tok)
            end = len(self.tokens)
            for n in range(self.min_n, self.max_n + 1):
                if end >= n:
                    gram = tuple(self.tokens[end - n:end])
                    prev = self._index.get(gram)
                    self._index[gram] = (end, prev[0] if prev else None)

    def propose(self) -> Optional[list[int]]:
        """Up to k draft tokens, or None when no tail n-gram has recurred."""
        end = len(self.tokens)
        if self._memo[0] == end:
            return self._memo[1]
        result: Optional[list[int]] = None
        for n in range(self.max_n, self.min_n - 1, -1):
            if end < n:
                continue
            hit = self._index.get(tuple(self.tokens[end - n:end]))
            if hit is None:
                continue
            latest, prev = hit
            pos = prev if latest == end else latest
            if pos is not None:
                drafts = self.tokens[pos:pos + self.k]
                if drafts:
                    result = drafts
                    break
        self._memo = (end, result)
        return result


def greedy_accept_counts(outs: torch.Tensor, drafts: torch.Tensor,
                         draft_lens: torch.Tensor) -> torch.Tensor:
    """``outs`` [N, S]: the per-position argmax of a verify span (S = k+1);
    ``drafts`` [N, S-1]: the proposed tokens; ``draft_lens`` [N]: how many
    are real. Returns [N] int32: the number of leading drafts equal to the
    model's own continuation (:func:`accept_length`, row by row)."""
    S = outs.shape[1]
    pos = torch.arange(S - 1, dtype=torch.int32, device=outs.device)[None, :]
    match = (drafts == outs[:, :-1]) & (pos < draft_lens[:, None])
    return torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)


def accept_length(drafts: list[int], outs: list[int]) -> int:
    """Greedy acceptance: the number of leading drafts equal to the model's
    own argmax continuation (``outs[i]`` is its token after draft prefix i)."""
    a = 0
    for i, d in enumerate(drafts):
        if d != outs[i]:
            break
        a += 1
    return a
