"""NeurLZ in PyTorch with hand-written CUDA kernels for the H100.

A port of the JAX package ``repro`` (which stays the reference) that
imports neither JAX nor anything of ``repro``.  The main path is the
paper's workload: ``NeurLZ(...).compress`` with the serial engine, the
``szlike`` interpolation predictor and strict regulation, then
``Archive.decode``; ``compressor="szlike-lorenzo"`` and ``"zfplike"`` and
per-field ``bounds=`` run too.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on CUDA tensors the ``conv2d3x3``,
``fused_enhance``, ``lorenzo3d_fwd`` and ``lorenzo3d_inv`` kernels run
(``repro_torch.kernels``), on CPU tensors their plain PyTorch versions.
``NeurLZ(telemetry=..., faults=...)`` traces a run and degrades a failed
field to conv-only; ``Archive.open`` reads whole-dict files and the
streaming containers ``NLZSTRM1``/``NLZSTRM2`` (lazily, with ``repair=True``
salvage and ``verify()``).

Subpackages: ``core`` (enhancer, trainer, regulation, conventional stage,
bounds, engine, archive and containers), ``compressors`` (registry, szlike,
zfplike and the byte layer), ``kernels`` (CUDA kernels and their build),
``obs`` (telemetry), ``faults`` (injection, retry, degradation), ``optim``,
``data`` (synthetic fields).
"""
from .api import (EngineConfig, ModelConfig, NeurLZ, RegulationConfig,
                  join_config, open, split_config)
from .core.archive import CorruptArchiveError
from .core.archive_api import Archive
from .core.bounds import ErrorBound
from .core.neurlz import NeurLZConfig
from .faults import FaultConfig, FaultInjector, InjectedFault, RetryPolicy
from .obs import Telemetry, TelemetryConfig

__version__ = "0.1.0"

__all__ = ["NeurLZ", "Archive", "ErrorBound", "ModelConfig", "EngineConfig",
           "RegulationConfig", "NeurLZConfig", "join_config", "split_config",
           "open", "Telemetry", "TelemetryConfig", "FaultConfig",
           "FaultInjector", "InjectedFault", "RetryPolicy",
           "CorruptArchiveError"]
