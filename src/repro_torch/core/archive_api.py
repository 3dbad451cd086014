"""``Archive``: a handle over one compressed snapshot (whole-dict format).

``Archive.open(path)`` loads a whole-dict archive file — written by this
package or by the JAX package, the bytes are the same format.
``decode(name)`` decodes one field with its cross-field aux closure,
``decode_all()`` every field, ``bitrate()`` gives the paper's accounting.
The handle is also a read-only mapping over the archive dict's keys.
Decoding runs on the handle's device (``cuda`` unless the caller asks for
the CPU).
"""
from __future__ import annotations

import os
from collections.abc import Mapping

import numpy as np

from .. import compressors
from .. import device as device_lib
from ..roadmap import unported
from . import archive as arc_io
from . import neurlz

_STREAM_MAGICS = (b"NLZSTRM1", b"NLZSTRM2")


class Archive(Mapping):
    def __init__(self, arc: dict, *, path: str | None = None, device=None):
        self._arc = arc
        self._path = path
        self.device = device_lib.resolve(device)

    @classmethod
    def open(cls, source, *, device=None) -> "Archive":
        """Load a whole-dict archive from a path or a binary file object."""
        if isinstance(source, (str, bytes, os.PathLike)):
            with open(source, "rb") as f:
                data = f.read()
            path = os.fspath(source)
        else:
            source.seek(0)
            data, path = source.read(), None
        if data[:8] in _STREAM_MAGICS:
            raise unported("the streaming container (NLZSTRM1/2)",
                           "the streaming containers NLZSTRM1/2")
        return cls(arc_io.loads(data), path=path, device=device)

    @classmethod
    def from_dict(cls, arc, *, device=None) -> "Archive":
        """Wrap an in-memory archive dict (no copy)."""
        if isinstance(arc, Archive):
            return arc
        return cls(arc, device=device)

    @property
    def path(self) -> str | None:
        return self._path

    @property
    def field_names(self) -> list[str]:
        return list(self._arc["fields"])

    def entry(self, name: str) -> dict:
        return self._arc["fields"][name]

    def decode(self, name: str) -> np.ndarray:
        """Decode one field: its entry plus the conventional payloads of
        its aux fields."""
        e = self.entry(name)
        recs = compressors.decompress_many(
            {n: self.entry(n)["conv"] for n in dict.fromkeys([name, *e["aux"]])},
            device=self.device)
        return neurlz.decode_field_entry(e, recs[name],
                                         [recs[a] for a in e["aux"]],
                                         self._arc["slice_axis"], self.device)

    def decode_all(self) -> dict[str, np.ndarray]:
        return neurlz.decompress(self._arc, self.device)

    def bitrate(self, name: str | None = None) -> dict:
        """Paper bit-rate accounting of one field, or of all."""
        table = self._arc.get("bitrate")
        if table is None:
            table = {n: neurlz.field_bitrate(
                self._arc, n, int(np.prod(self.entry(n)["conv"]["shape"])))
                for n in self.field_names}
        return table if name is None else table[name]

    def to_dict(self) -> dict:
        return self._arc

    def save(self, path) -> int:
        """Write the whole-dict archive file; returns bytes written."""
        return arc_io.save(os.fspath(path), self._arc)

    def __getitem__(self, key):
        return self._arc[key]

    def __iter__(self):
        return iter(self._arc)

    def __len__(self) -> int:
        return len(self._arc)

    def __repr__(self) -> str:
        where = f" path={self._path!r}" if self._path else ""
        return f"<Archive{where} fields={len(self.field_names)} device={self.device}>"
