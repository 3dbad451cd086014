"""Error-bounded linear quantization constants.

``code = round((value - pred) / (2 eb))`` and ``rec = pred + code * 2 eb``
keep ``|rec - value| <= eb`` while ``|code| < CODE_CAP``; points at or past
the cap are stored as literals.  The bound itself is computed on the host
with numpy, in the same order as the JAX package, because every code of an
archive depends on its last bit.
"""
from __future__ import annotations

import numpy as np

CODE_CAP = 1 << 15


def abs_bound_from_rel(x, rel_eb: float) -> float:
    """Value-range-relative bound -> absolute bound (SZ3 ``-M REL``)."""
    x = np.asarray(x)
    finite = x[np.isfinite(x)]
    if finite.size == 0:
        return float(rel_eb)
    vrange = float(finite.max() - finite.min())
    if vrange == 0.0:
        vrange = max(abs(float(finite.max())), 1.0)
    return float(rel_eb) * vrange
