"""Small cross-cutting helpers with no better home.

``warn_fresh`` exists because Python's warning machinery dedupes
"default"-action warnings on (message, category, lineno) in a per-module
registry that lives for the whole *process*: a data-quality warning (the
``max_fanout`` eval truncation in ``data/kg.KG``) would fire for the first
evaluation and be swallowed for every later one in the same process, even
though each drops its own counts.  These are once-per-*call* reports.
"""
from __future__ import annotations

import sys
import warnings


def warn_fresh(msg: str, category: type = UserWarning,
               stacklevel: int = 2) -> None:
    """``warnings.warn(msg, category, stacklevel=...)`` minus the
    per-process once-only dedupe: each call hands ``warn_explicit`` a
    fresh registry, so every call surfaces its own report while remaining
    an ordinary warning for filters, ``-W error`` and ``pytest.warns``."""
    frame = sys._getframe(stacklevel)
    warnings.warn_explicit(
        msg,
        category,
        frame.f_code.co_filename,
        frame.f_lineno,
        module=frame.f_globals.get("__name__", "<unknown>"),
        registry={},
    )
