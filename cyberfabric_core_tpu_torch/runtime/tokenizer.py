"""Tokenizers and chat rendering: the port's copy of ``runtime/tokenizer.py``.

:class:`ByteTokenizer` keeps every path (encode → device → decode) real
without a checkpoint: ids 0-2 are pad/bos/eos, byte b maps to 3+b.
:class:`HfTokenizer` wraps a checkpoint's ``tokenizer.json`` through the
``tokenizers`` package, imported when one is built; :func:`load_tokenizer`
picks it when the directory has that file. :func:`render_chat` renders a
conversation in each family's published chat template.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Protocol, Sequence, Union


class Tokenizer(Protocol):
    pad_id: int
    bos_id: int
    eos_id: int

    def encode(self, text: str, add_specials: bool = True) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer:
    pad_id = 0
    bos_id = 1
    eos_id = 2
    _OFFSET = 3

    def __init__(self, vocab_size: int = 512) -> None:
        self.vocab_size = vocab_size

    def encode(self, text: str, add_specials: bool = True) -> list[int]:
        lead = [self.bos_id] if add_specials else []
        return lead + [self._OFFSET + b for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        # ids beyond the byte range (vocab slack above 258, e.g. random-weight
        # sampling) decode to the replacement character instead of crashing
        data = bytes(
            (i - self._OFFSET) if i - self._OFFSET < 256 else 0x3F  # '?'
            for i in ids
            if i >= self._OFFSET
        )
        return data.decode("utf-8", errors="replace")


class HfTokenizer:
    """Wraps a ``tokenizers`` Tokenizer loaded from ``tokenizer.json``.
    Without the ``tokenizers`` package it raises :class:`ImportError`: a
    checkpoint's vocabulary is never replaced by the byte tokenizer."""

    def __init__(self, path: Union[str, Path]) -> None:
        try:
            from tokenizers import Tokenizer as _Tok
        except ImportError as e:
            raise ImportError(
                f"{path} needs the 'tokenizers' package, which is not installed; "
                "the checkpoint's vocabulary has no fallback") from e
        self._tok = _Tok.from_file(str(path))
        self.pad_id = self._special("<|pad|>", "<pad>", default=0)
        self.bos_id = self._special("<|begin_of_text|>", "<s>", "<|startoftext|>", default=1)
        self.eos_id = self._special("<|end_of_text|>", "</s>", "<|eot_id|>", default=2)

    def _special(self, *names: str, default: int) -> int:
        for n in names:
            tid = self._tok.token_to_id(n)
            if tid is not None:
                return tid
        return default

    def encode(self, text: str, add_specials: bool = True) -> list[int]:
        # add_specials=False for chat-templated prompts: the rendered template
        # already carries bos/headers literally, and a tokenizer.json whose
        # post-processor auto-adds bos would otherwise double it.
        return self._tok.encode(text, add_special_tokens=add_specials).ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)


def load_tokenizer(model_dir: Optional[Union[str, Path]], vocab_size: int = 512) -> Tokenizer:
    """``tokenizer.json`` in ``model_dir`` → :class:`HfTokenizer`; no such
    file (or no directory) → :class:`ByteTokenizer`."""
    if model_dir is not None:
        p = Path(model_dir) / "tokenizer.json"
        if p.exists():
            return HfTokenizer(p)
    return ByteTokenizer(vocab_size)


#: families render_chat implements; worker validates engine_options.chat_family
#: against this so a typo fails at engine build, not as silent generic prompts
CHAT_FAMILIES = ("llama", "qwen2", "chatml", "gemma", "mistral", "generic")


def chat_family_for(model_name: str) -> str:
    """Model/config name → chat-template family (worker uses this when the
    registry entry doesn't pin one explicitly via engine_options.chat_family)."""
    n = model_name.lower()
    if "gemma" in n:
        return "gemma"
    if "qwen" in n:
        return "qwen2"
    if "mistral" in n or "mixtral" in n:
        return "mistral"
    return "llama"


def _fold_system_into_user(messages: list[tuple[str, str]],
                           system_parts: list[tuple[int, str]]) -> list[tuple[str, str]]:
    """Fold each system text into the user turn at its own position, or
    insert a synthetic user turn there when the next turn isn't user — for
    families whose published template has no system role. Chronological order
    is preserved and no instruction is ever silently dropped."""
    out = list(messages)
    for idx, text in reversed(system_parts):
        if idx < len(out) and out[idx][0] == "user":
            out[idx] = ("user", f"{text}\n\n{out[idx][1]}")
        else:
            out.insert(min(idx, len(out)), ("user", text))
    return out


def render_chat(messages: list[dict], model_family: str = "llama") -> str:
    """Messages → prompt text, matching each family's published chat template
    byte-for-byte (transformers' apply_chat_template renders the same).
    Content is an array of parts per the wire contract (a plain string is
    taken too); text parts are joined."""

    def text_of(content) -> str:
        if isinstance(content, str):
            return content
        return "".join(p.get("text", "") for p in content if p.get("type", "text") == "text")

    if model_family == "llama":
        # Llama-3 instruct format: bos, then per-message header blocks, then
        # the assistant generation header.
        out = ["<|begin_of_text|>"]
        for m in messages:
            out.append(f"<|start_header_id|>{m['role']}<|end_header_id|>"
                       f"\n\n{text_of(m['content']).strip()}<|eot_id|>")
        out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        return "".join(out)
    if model_family in ("qwen2", "chatml"):
        # ChatML (Qwen2 family): <|im_start|>role\ncontent<|im_end|>\n
        out = []
        for m in messages:
            out.append(f"<|im_start|>{m['role']}\n"
                       f"{text_of(m['content'])}<|im_end|>\n")
        out.append("<|im_start|>assistant\n")
        return "".join(out)
    if model_family in ("gemma", "mistral"):
        # Neither family's published template has a system role — system turns
        # fold into the next user turn (or become one) instead of crashing the
        # wire contract or being dropped.
        system_parts: list[tuple[int, str]] = []
        turns: list[tuple[str, str]] = []
        for m in messages:
            role = m["role"]
            if role == "system":
                system_parts.append((len(turns), text_of(m["content"]).strip()))
                continue
            turns.append((role, text_of(m["content"]).strip()))
        turns = _fold_system_into_user(turns, system_parts)
        if model_family == "gemma":
            # Gemma turns: assistant renders as "model"
            out = ["<bos>"]
            for role, text in turns:
                out.append(f"<start_of_turn>"
                           f"{'model' if role == 'assistant' else role}\n"
                           f"{text}<end_of_turn>\n")
            out.append("<start_of_turn>model\n")
            return "".join(out)
        # Mistral/Mixtral [INST] format: generation continues after [/INST],
        # so there is no generation-prompt suffix.
        out = ["<s>"]
        for role, text in turns:
            if role == "user":
                out.append(f"[INST] {text} [/INST]")
            elif role == "assistant":
                out.append(f"{text}</s>")
        return "".join(out)
    # generic fallback
    lines = [f"{m['role']}: {text_of(m['content'])}" for m in messages]
    lines.append("assistant:")
    return "\n".join(lines)
