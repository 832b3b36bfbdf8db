"""String-keyed registry of KG scoring models (port of
``repro.core.models``).

    from repro_torch.core.models import get_model
    model = get_model("transe")

Only TransE is ported so far; asking for another model the reference
registers raises a "not ported yet" error instead of "unknown model".
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
from repro_torch.core.models.transe import TransE

# registered in the reference, waiting for their port (ROADMAP queue 1)
NOT_PORTED = ("distmult", "transh")

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
        if name_or_model in NOT_PORTED:
            raise NotImplementedError(
                f"KG model {name_or_model!r} is not ported to repro_torch "
                f"yet (ROADMAP.md queue 1); ported: {available()}")
        raise ValueError(
            f"unknown KG model {name_or_model!r}; registered: {available()}"
        )
    return model


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register(TransE())
