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
salvage and ``verify()``).  ``engine="batched"`` trains groups of fields
stacked; ``NeurLZ.compress_to`` (and ``engine="streaming"``) streams a
snapshot out of core under ``max_resident_bytes``, with ``resume=True``,
and ``Archive.decode(name, roi=...)`` decodes one region.
``learn_residual=False`` runs the paper's direct-learning ablation.
``ArchiveServer`` serves decoded fields to concurrent readers (coalesced
decodes, a ledger-charged hot-field cache) and ``transcode`` re-targets a
stored archive to new bounds; both load lazily from ``repro_torch.serve``.

Subpackages: ``core`` (enhancer, trainer, regulation, conventional stage,
bounds, serial and batched engines, archive and containers), ``serve``
(the archive server and transcode), ``streaming`` (lazy field sources,
the bounded-memory scheduler and its residency ledger, the async writer,
``iter_decompress``), ``compressors``
(registry, szlike, zfplike and the byte layer), ``kernels`` (CUDA kernels
and their build), ``obs`` (telemetry), ``faults`` (injection, retry,
degradation, the straggler watchdog of ``checkpoint``), ``optim``,
``data`` (the synthetic Nyx, Miranda and Hurricane fields, and the LM's
token stream).  The off-paper LM substrate's serving path loads on its
own: ``configs`` (the ten archs), ``models`` (the attention families) and
``launch.serve``.
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
           "CorruptArchiveError", "ArchiveServer", "transcode"]


def __getattr__(name: str):
    # The serving tier loads on first touch: ``import repro_torch`` does not
    # pay the serve chain's imports.
    if name in ("ArchiveServer", "transcode"):
        from . import serve
        value = getattr(serve, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
