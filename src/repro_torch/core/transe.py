"""Deprecation shim: TransE lives in ``repro_torch.core.models.transe``
(port of ``repro.core.transe``).

The engine math shared by every model (margin loss, SGD steps, local
epochs, BGD gradients) is ``repro_torch.core.models.base.KGModel``'s;
TransE is one registered model.  This module keeps the single-model API:

    from repro_torch.core import transe
    transe.TransEConfig(...)          # alias of models.base.KGConfig
    transe.init_params / energy / margin_loss / run_epoch / ...

Every function delegates to the registered TransE instance, bit for bit.
``init_params`` takes a CPU ``torch.Generator`` (and a ``device``) where
the reference takes a JAX key.
"""
from __future__ import annotations

import torch

from repro_torch.core.models import base as _base
from repro_torch.core.models import get_model as _get_model

_MODEL = _get_model("transe")

# aliases of the shared types (same objects, old names)
TransEConfig = _base.KGConfig
Params = _base.Params
EpochStats = _base.EpochStats
pairwise_hinge = _base.pairwise_hinge
apply_gradients = _base.apply_gradients
_dissimilarity = _base.dissimilarity


def init_params(generator: torch.Generator, cfg: TransEConfig,
                device=None) -> Params:
    return _MODEL.init_params(generator, cfg, device=device)


def normalize_entities(params: Params) -> Params:
    return _MODEL.normalize(params)


def energy(params: Params, triplets, norm: str = "l1") -> torch.Tensor:
    return _MODEL.energy(params, triplets, norm)


def margin_loss(params, pos, neg, *, margin: float, norm: str
                ) -> torch.Tensor:
    return _MODEL.margin_loss(params, pos, neg, margin=margin, norm=norm)


def per_pair_loss(params, pos, neg, *, margin: float, norm: str
                  ) -> torch.Tensor:
    return _MODEL.per_pair_loss(params, pos, neg, margin=margin, norm=norm)


def sgd_step(params, pos, neg, cfg: TransEConfig):
    return _MODEL.sgd_step(params, pos, neg, cfg)


def run_epoch(params, pos_batches, neg_batches, cfg: TransEConfig):
    return _MODEL.run_epoch(params, pos_batches, neg_batches, cfg)


def batch_gradients(params, pos, neg, cfg: TransEConfig):
    return _MODEL.batch_gradients(params, pos, neg, cfg)
