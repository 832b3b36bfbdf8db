"""Top-level API of the port, built around the
:class:`~repro_torch.kb.KnowledgeBase` artifact (port of ``repro.kg``;
``fit`` comes with the training slice).

    from repro_torch import kg

    kb = kg.KnowledgeBase.load("my_kb")   # saved by either package
    metrics = kg.evaluate(kb, engine="device")
"""
from __future__ import annotations

from typing import Optional

from repro_torch import kb as kb_lib
from repro_torch.core import eval as kg_eval
from repro_torch.core.models import KGModel, available

KnowledgeBase = kb_lib.KnowledgeBase


def models() -> tuple:
    """Names of all registered scoring models."""
    return available()


def evaluate(
    params,
    model: "str | KGModel | None" = None,
    kg=None,
    *,
    norm: Optional[str] = None,
    filtered: bool = True,
    engine: str = "host",
    **engine_kw,
) -> dict:
    """All three paper tasks (entity inference, relation prediction,
    triplet classification).

    Accepts a :class:`KnowledgeBase` (``evaluate(kb)`` — model, graph and
    norm come from the artifact; any explicitly passed value overrides) or
    the raw ``(params, model, kg)`` triple.  ``engine="host"`` is the
    reference protocol loop, ``engine="device"`` the device engine
    (identical numbers); its options (``chunk``, ``fused``,
    ``max_fanout``) ride in ``engine_kw`` — see
    ``repro_torch.core.eval_device.evaluate_all_device``."""
    if isinstance(params, kb_lib.KnowledgeBase):
        kb = params
        params = kb.params
        model = kb.model if model is None else model
        kg = kb.graph if kg is None else kg
        norm = kb.norm if norm is None else norm
        if kg is None:
            raise ValueError(
                "this KnowledgeBase carries no graph (loaded with "
                "include_graph=False?) — pass kg= explicitly")
    elif model is None or kg is None:
        raise TypeError(
            "evaluate(params, ...) needs model= and kg= when params is a "
            "raw table dict (or pass a KnowledgeBase)")
    return kg_eval.evaluate_all(
        params, kg, norm=norm or "l1", filtered=filtered, model=model,
        engine=engine, **engine_kw
    )
