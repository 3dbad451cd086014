"""`repro_torch.serve`: archive serving and transcode tier (the port of the
JAX package's ``repro/serve``).

The read side of the streaming encoder: many consumers ask one process for
decoded fields, and the process answers fast without breaking one shared
memory ceiling.

* :class:`ArchiveServer`: concurrent decode requests (submit/future or
  blocking :meth:`~ArchiveServer.decode`), **coalesced** into stacked
  ``decompress_batched`` calls when same-signature requests land in the
  same batching window, fronted by a :class:`HotFieldCache` whose bytes
  are charged to the streaming engine's
  :class:`~repro_torch.streaming.pipeline.ResidencyLedger`.  Every decode
  runs on the server's dispatcher thread, on its device.
* :func:`transcode`: re-target a stored archive to new per-field error
  bounds, streaming entry by entry under the same ledger and writing a
  fresh container whose entries equal a whole-snapshot recompress's.

Quickstart::

    from repro_torch.serve import ArchiveServer, transcode

    with ArchiveServer("snapshot.nlz", max_bytes=1 << 30) as srv:
        temp = srv.decode("temperature")               # cold: decodes
        temp = srv.decode("temperature")               # hot: cache
        slab = srv.decode("velocity_x", roi=(slice(8, 16),))
        futs = [srv.submit(n) for n in ("f0", "f1", "f2")]
        fields = [f.result() for f in futs]            # coalesced batch

    transcode("snapshot.nlz", "cheap.nlz", bounds={"temperature": 1e-2},
              rel_eb=1e-3)

Instrumentation rides on ``repro_torch.obs`` (``serve.*`` counters, a
``serve.coalesce_width`` gauge, spans under a ``serve`` root span) and
fault handling on ``repro_torch.faults`` (site ``"serve.request"``: an
injected fault fails that request's future, never the server).
"""
from __future__ import annotations

from .cache import HotFieldCache
from .coalesce import Coalescer, Future, Request
from .server import ArchiveServer
from .transcode import ArchiveSource, transcode

__all__ = ["ArchiveServer", "ArchiveSource", "Coalescer", "Future",
           "HotFieldCache", "Request", "transcode"]
