"""Module SDK contracts the port's chat path uses (the port's copy of
``modules/sdk.py:32-115``): the resolved model, the worker's stream unit,
and the worker and registry interfaces."""

from __future__ import annotations

import abc
import dataclasses
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Optional

from ..modkit.errcat import ERR
from ..modkit.security import SecurityContext


@dataclass
class ModelInfo:
    """A resolved model. canonical_id = ``{provider_slug}::{provider_model_id}``;
    managed/architecture/size_bytes/format are the infrastructure fields of
    a local model."""

    canonical_id: str
    provider_slug: str
    provider_model_id: str
    display_name: str = ""
    capabilities: dict[str, bool] = field(default_factory=dict)
    limits: dict[str, Any] = field(default_factory=dict)
    cost: dict[str, float] = field(default_factory=dict)
    lifecycle_status: str = "active"
    approval_state: str = "approved"
    managed: bool = False
    architecture: Optional[str] = None
    size_bytes: Optional[int] = None
    format: Optional[str] = None
    checkpoint_path: Optional[str] = None
    engine_options: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


class ModelRegistryApi(abc.ABC):
    @abc.abstractmethod
    async def resolve(self, ctx: SecurityContext, name: str) -> ModelInfo:
        """A model name or alias → a served model; raises a 404/403 problem."""

    @abc.abstractmethod
    async def list_models(self, ctx: SecurityContext) -> list[ModelInfo]:
        ...


@dataclass
class ChatStreamChunk:
    """Internal stream unit between the worker and the llm-gateway layer."""

    request_id: str
    text: str = ""
    token_id: Optional[int] = None
    finish_reason: Optional[str] = None
    usage: Optional[dict[str, int]] = None


class LlmWorkerApi(abc.ABC):
    """The local-worker backend contract."""

    @abc.abstractmethod
    def chat_stream(self, model: ModelInfo, messages: list[dict],
                    params: dict) -> AsyncIterator[ChatStreamChunk]:
        ...

    async def completion_stream(self, model: ModelInfo, prompt: str,
                                params: dict) -> AsyncIterator[ChatStreamChunk]:
        """Raw text completion. Default: the prompt as one user message
        through :meth:`chat_stream`; the local worker overrides it to skip
        the chat template."""
        async for chunk in self.chat_stream(model, [
                {"role": "user", "content": [{"type": "text", "text": prompt}]}], params):
            yield chunk

    @abc.abstractmethod
    async def embed(self, model: ModelInfo, inputs: list[str],
                    params: dict) -> tuple[list[list[float]], int]:
        """(one vector per input, the inputs' token count)."""

    @abc.abstractmethod
    async def health(self) -> dict[str, Any]:
        ...
