"""Model registry: model name -> engine loop (or embedder) + tokenizer
(port of ``helix_tpu/serving/registry.py``).  Unknown names answer 404
with the available list at the HTTP layer.  An embedding model
(``kind="embedding"``) has an ``embedder`` and no ``loop``; a vision
chat model (``kind="vision"``) has a ``loop`` and a ``vision`` runner
(``serving.vision.VisionRunner``); a vision embedder
(``kind="vision-embedding"``) an ``embedder`` and no ``loop``.

``DelegatingRegistry`` (the reference's, ``helix_tpu/control/
node_agent.py:440-462``) is the one surface the server and ``serve-node``
hold: it forwards to a plain ``ModelRegistry`` or to an
``engine.residency.ResidencyManager``, whose ``get`` loads models on
demand."""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from helix_tpu_torch.serving.engine_loop import EngineLoop


@dataclasses.dataclass
class ServedModel:
    name: str
    loop: Optional[EngineLoop]
    tokenizer: object
    kind: str = "chat"   # chat | embedding | vision | vision-embedding
    created: int = dataclasses.field(default_factory=lambda: int(time.time()))
    owned_by: str = "helix-tpu"
    context_length: Optional[int] = None
    # seconds of each stage of the build (cli.build_served_model)
    build_seconds: Optional[dict] = None
    # a checkpoint load's bytes and read / upload seconds
    # (models.loader.load_params)
    load_stats: Optional[dict] = None
    # models.bge.EmbeddingRunner for kind == "embedding", models.
    # vision_embed.VisionEmbeddingRunner for "vision-embedding" (loop None)
    embedder: object = None
    vision: object = None        # VisionRunner for kind == "vision"


class ModelRegistry:
    def __init__(self):
        self._models: dict[str, ServedModel] = {}

    def register(self, model: ServedModel):
        self._models[model.name] = model

    def unregister(self, name: str):
        m = self._models.pop(name, None)
        if m is not None and m.loop is not None:
            m.loop.stop(join=False)

    def get(self, name: str) -> Optional[ServedModel]:
        return self._models.get(name)

    def names(self) -> list:
        return sorted(self._models)

    def list(self) -> list:
        return [self._models[n] for n in self.names()]


class DelegatingRegistry:
    """Stable registry handle over a ``ModelRegistry`` or a
    ``ResidencyManager`` (``inner``), so the HTTP server takes either."""

    def __init__(self, inner=None):
        self.inner = inner or ModelRegistry()

    def get(self, name):
        return self.inner.get(name)

    def names(self):
        return self.inner.names()

    def list(self):
        return self.inner.list()

    def register(self, model):
        return self.inner.register(model)

    def unregister(self, name):
        if hasattr(self.inner, "unregister"):
            return self.inner.unregister(name)
        return self.inner.evict(name)
