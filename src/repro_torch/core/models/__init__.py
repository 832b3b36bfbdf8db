"""String-keyed registry of KG scoring models (port of
``repro.core.models``).

    from repro_torch.core.models import get_model
    model = get_model("distmult")

The reference's three models are registered: TransE, TransH, DistMult.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.models.base import (  # noqa: F401  (re-exported API)
    EpochStats,
    KGConfig,
    KGModel,
    Params,
    apply_gradients,
    dissimilarity,
    pairwise_hinge,
)
from repro_torch.core.models.distmult import DistMult
from repro_torch.core.models.transe import TransE
from repro_torch.core.models.transh import TransH

_REGISTRY: Dict[str, KGModel] = {}


def register(model: KGModel) -> KGModel:
    """Register a model instance under its ``name`` (last write wins)."""
    if not isinstance(model, KGModel):
        raise TypeError(f"expected a KGModel instance, got {type(model)!r}")
    _REGISTRY[model.name] = model
    return model


def get_model(name_or_model: "str | KGModel") -> KGModel:
    """Resolve a registry name (or pass a model instance through)."""
    if isinstance(name_or_model, KGModel):
        return name_or_model
    model = _REGISTRY.get(name_or_model)
    if model is None:
        raise ValueError(
            f"unknown KG model {name_or_model!r}; registered: {available()}"
        )
    return model


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register(TransE())
register(TransH())
register(DistMult())
