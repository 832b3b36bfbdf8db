"""Scoring models, negatives and the evaluation protocol (port of
``repro.core``)."""
