"""Conventional error-bounded compressors (the substrate NeurLZ enhances).

The port has one so far: ``szlike`` with the interpolation predictor.
Dispatch goes by compressor name on the way in and by the archive's
``kind`` on the way out; anything else is not ported yet and raises.
Both run on ``cuda`` unless the caller passes another device.
"""
from ..roadmap import unported
from . import codec, entropy, outliers, szlike  # noqa: F401
from .quantize import CODE_CAP, abs_bound_from_rel  # noqa: F401
from .szlike import _LORENZO_ITEM as _ITEM


def _check_kind(arc: dict) -> None:
    if arc.get("kind") != "szlike":
        raise unported(f"archive kind {arc.get('kind')!r}", _ITEM)


def compress(x, rel_eb=None, *, abs_eb=None, compressor="szlike",
             device=None):
    if compressor != "szlike":
        raise unported(f"compressor {compressor!r}", _ITEM)
    return szlike.compress(x, rel_eb, abs_eb=abs_eb, device=device)


def decompress(arc: dict, device=None):
    _check_kind(arc)
    return szlike.decompress(arc, device=device)


def archive_nbytes(arc: dict) -> int:
    _check_kind(arc)
    return szlike.archive_nbytes(arc)
