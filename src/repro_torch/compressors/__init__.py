"""Conventional error-bounded compressors (the substrate NeurLZ enhances).

Dispatch goes through the registry (:mod:`repro_torch.compressors.registry`):
``compress`` resolves a registered compressor by name, ``decompress`` and
``archive_nbytes`` the archive's ``kind`` tag; an unknown name or kind is an
error.  Built-ins: ``szlike`` (interpolation predictor), ``szlike-lorenzo``
(the ``lorenzo3d`` kernels) and ``zfplike``.  Entry points run on ``cuda``
unless the caller passes another device.
"""
from . import codec, entropy, outliers, registry, szlike, zfplike  # noqa: F401
from .quantize import CODE_CAP, abs_bound_from_rel  # noqa: F401
from .registry import archive_nbytes, compress, decompress, decompress_many  # noqa: F401

registry._register_builtins()
