"""Streaming snapshot pipeline: bounded-memory chunked ingestion + async
archive writer (the port of the JAX package's ``repro/streaming``).

Public API:
    compress / iter_decompress / decompress — out-of-core snapshot codec
    StreamConfig, ResidencyLedger           — scheduler knobs + accounting
    ChunkedFieldSource + implementations    — lazy snapshot inputs
    AsyncArchiveWriter                      — writer-thread archival
"""
from .pipeline import (PipelineScheduler, ResidencyLedger,  # noqa: F401
                       StreamConfig, compress, compress_dict, decompress,
                       iter_decompress, order_groups)
from .source import (BlockedSource, ChunkedFieldSource, DictSource,  # noqa: F401
                     FieldMeta, FunctionSource, NpyDirSource, as_source,
                     synthetic_snapshot_source)
from .writer import AsyncArchiveWriter, EntryTask  # noqa: F401
