"""Fault-tolerant checkpointing of the LM trainer's state.

The port of the JAX package's ``repro/checkpoint/checkpoint.py``, with its
own copy of the flat-array format (numpy and the port's msgpack subset; no
msgpack wheel, no JAX, no ``ml_dtypes``):

  * **atomic** — write to ``step_N.tmp/`` then ``rename``; a crash mid-save
    never corrupts the latest checkpoint;
  * **manifest** — ``manifest.json`` lists steps; ``latest_step()`` is what
    a restart reads; retention keeps the newest K;
  * **self-describing** — parameters and optimizer state are stored as a
    flat ``{path: array}`` msgpack blob with dtype and shape, compressed by
    the codec layer (zstd where installed, else zlib).  The paths are the
    JAX package's (``layers/attn/w_q_in``; an :class:`AdamWState`'s fields
    as ``.step``, ``.mu/<path>``, ``.nu/<path>``), and for the same tree the
    files hold the same bytes, so a checkpoint written by either package
    restores in the other;
  * **NeurLZ-compressed weights** — with ``lossy_weights_eb``, every
    float32 or float64 weight of 2 or more dimensions (4-D and up reshaped
    to ``[shape[0], -1]``) goes through ``szlike`` with the Lorenzo
    predictor on the manager's device (the ``lorenzo3d_fwd`` /
    ``lorenzo3d_inv`` kernels on the card) under a strict ``eb · range``
    bound; optimizer moments stay lossless.

bfloat16 leaves are written as their raw 16 bits with dtype
``"bfloat16"`` and read back without a numpy ``bfloat16`` type.
"""
from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from .. import device as device_lib
from ..compressors import codec
from ..core.archive import dumps as _packb
from ..core.archive import loads as _unpackb


def _walk(tree, prefix=()):
    """``(path, leaf)`` in ``jax.tree_util.tree_flatten_with_path`` order:
    dict keys sorted, a NamedTuple's fields in order as ``.name``, a list's
    items by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _walk(getattr(tree, name), prefix + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _host(leaf):
    """A leaf on the host: a CPU tensor for tensors (a DTensor gathered to
    its full tensor), else a numpy array (an int step as the JAX package's
    int32 scalar)."""
    if isinstance(leaf, torch.Tensor):
        if hasattr(leaf, "full_tensor"):      # a DTensor: mesh-agnostic file
            leaf = leaf.full_tensor()
        return leaf.detach().cpu().contiguous()
    if isinstance(leaf, (bool, int)) and not isinstance(leaf, np.generic):
        return np.asarray(leaf, dtype=np.int32)
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    return {"/".join(path): _host(leaf) for path, leaf in _walk(tree)}


def _dtype_name(a) -> str:
    if isinstance(a, torch.Tensor):
        return str(a.dtype).split(".")[1]
    return str(a.dtype)


def _raw_bytes(a) -> bytes:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().tobytes()
        return a.numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


def _pack_arrays(flat: dict, level: int = 3, lossy_eb: float | None = None,
                 device=None) -> bytes:
    entries = {}
    for k, a in flat.items():
        # As numpy.ascontiguousarray in the JAX package: at least 1-D, so a
        # scalar (the step) is written with shape [1].
        a = a.reshape(1) if a.ndim == 0 else a
        dtype = _dtype_name(a)
        if lossy_eb is not None and dtype in ("float32", "float64") and a.ndim >= 2:
            # NeurLZ error-bounded weight compression (strict 1x bound).
            from ..compressors import szlike

            x = a.numpy() if isinstance(a, torch.Tensor) else np.ascontiguousarray(a)
            arc, _ = szlike.compress(
                x if x.ndim in (2, 3) else x.reshape(x.shape[0], -1),
                rel_eb=lossy_eb,
                config=szlike.SZLikeConfig(predictor="lorenzo"), device=device)
            entries[k] = {"kind": "szlike", "arc": _packb(arc),
                          "shape": list(a.shape), "dtype": dtype}
        else:
            entries[k] = {"kind": "raw", "dtype": dtype,
                          "shape": list(a.shape), "data": _raw_bytes(a)}
    return codec.compress(_packb(entries), level)[0]


def _from_raw(data: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.frombuffer(data, dtype=np.int16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(data, dtype=dtype).reshape(shape).copy())


def _unpack_arrays(data: bytes, device=None) -> dict:
    """``{path: CPU tensor}``; lossy entries are decoded on ``device``."""
    entries = _unpackb(codec.decompress_sniffed(data))
    out = {}
    for k, e in entries.items():
        if e.get("kind", "raw") == "szlike":
            from ..compressors import szlike

            arr = szlike.decompress(_unpackb(e["arc"]), device=device)
            out[k] = torch.from_numpy(
                np.ascontiguousarray(arr.reshape(e["shape"]).astype(e["dtype"])))
        else:
            out[k] = _from_raw(e["data"], e["dtype"], e["shape"])
    return out


def _unflatten_into(template, flat: dict, device, path: tuple = ()):
    """A tree shaped like ``template`` from ``flat``: each leaf in the
    template's dtype and shape, on ``device`` (an int leaf as an int).
    Module-level recursion, not a closure: a recursive closure is a
    reference cycle that would hold ``flat`` until the cyclic collector
    runs."""
    t = template
    if isinstance(t, dict):
        return {k: _unflatten_into(t[k], flat, device, path + (str(k),)) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_unflatten_into(getattr(t, n), flat, device, path + (f".{n}",))
                         for n in t._fields))
    if isinstance(t, (list, tuple)):
        return type(t)(_unflatten_into(v, flat, device, path + (str(i),))
                       for i, v in enumerate(t))
    arr = flat["/".join(path)]
    if isinstance(t, torch.Tensor):
        return arr.to(t.dtype).reshape(t.shape).to(device)
    return int(arr.item())


class CheckpointManager:
    """Checkpoints under ``directory``, written and read on ``device``
    (``cuda`` unless given: it runs the lossy weights' compressor and
    holds the restored tensors)."""

    def __init__(self, directory: str, keep: int = 3,
                 lossy_weights_eb: float | None = None, device=None):
        self.dir = directory
        self.keep = keep
        self.lossy_eb = lossy_weights_eb
        self.device = device_lib.resolve(device)
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, params, opt_state=None, extra: dict | None = None):
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        t0 = time.time()
        with open(os.path.join(tmp, "params.bin"), "wb") as f:
            f.write(_pack_arrays(_flatten(params), lossy_eb=self.lossy_eb,
                                 device=self.device))
        if opt_state is not None:
            with open(os.path.join(tmp, "opt.bin"), "wb") as f:
                f.write(_pack_arrays(_flatten(opt_state)))
        meta = {"step": int(step), "time": time.time(),
                "save_seconds": time.time() - t0,
                "lossy_weights_eb": self.lossy_eb,
                "extra": extra or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                     # atomic publish
        self._update_manifest(step)
        self._retain()
        return final

    def _write_manifest(self, man: dict) -> None:
        tmp = os.path.join(self.dir, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(man, f)
        os.replace(tmp, os.path.join(self.dir, "manifest.json"))

    def _update_manifest(self, step: int):
        man = self.manifest()
        if step not in man["steps"]:
            man["steps"].append(int(step))
            man["steps"].sort()
        self._write_manifest(man)

    def _retain(self):
        man = self.manifest()
        while len(man["steps"]) > self.keep:
            victim = man["steps"].pop(0)
            path = os.path.join(self.dir, f"step_{victim}")
            if os.path.exists(path):
                shutil.rmtree(path)
        self._write_manifest(man)

    # --------------------------------------------------------------- restore
    def manifest(self) -> dict:
        path = os.path.join(self.dir, "manifest.json")
        if not os.path.exists(path):
            return {"steps": []}
        with open(path) as f:
            return json.load(f)

    def latest_step(self) -> int | None:
        steps = self.manifest()["steps"]
        # Tolerate a manifest entry whose directory was lost (partial node
        # failure): fall back to the newest complete checkpoint.
        for s in sorted(steps, reverse=True):
            if os.path.exists(os.path.join(self.dir, f"step_{s}", "meta.json")):
                return s
        return None

    def restore(self, step: int, params_template, opt_template=None):
        """``(params, opt_state, meta)``: new trees shaped like the
        templates, on the manager's device (register the parameters with
        ``model.load_params`` to train them)."""
        base = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(base, "params.bin"), "rb") as f:
            params = _unflatten_into(params_template,
                                     _unpack_arrays(f.read(), self.device),
                                     self.device)
        opt = None
        if opt_template is not None:
            with open(os.path.join(base, "opt.bin"), "rb") as f:
                opt = _unflatten_into(opt_template,
                                      _unpack_arrays(f.read(), self.device),
                                      self.device)
        with open(os.path.join(base, "meta.json")) as f:
            meta = json.load(f)
        return params, opt, meta
