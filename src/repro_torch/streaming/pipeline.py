"""Bounded-memory streaming scheduler over the batched engine's group plan.

The port of the JAX package's ``repro/streaming/pipeline.py``.  The
in-memory engines materialize every field, keep every conventional
reconstruction resident for cross-field aux channels, and assemble the
full archive dict before a byte hits disk.  This scheduler runs the same
compression as a dataflow with a hard residency budget:

* **Plan from metadata** — groups come from
  :func:`repro_torch.core.batched_engine.plan_groups_from_meta` using only
  field shapes, then are walked in a cross-field dependency-aware order
  (:func:`order_groups`): greedily pick the group that frees the most
  resident reconstruction bytes and materializes the fewest new ones.
* **Refcounted residency** — each conventional reconstruction carries a
  refcount (its own finalize + one per cross-field consumer) and is
  evicted the moment the last consumer finishes.  Originals are evicted
  right after their group's outlier capture; an aux producer whose own
  group runs later is conv-compressed early from a transient load.
* **Hard budget** — every resident host array (originals ``x:``,
  reconstructions ``rec:``, training datasets ``ds:``, transient loads
  ``tmpx:`` and the fused conventional stage's working copies
  ``convtmp``) is charged to a :class:`ResidencyLedger` at the JAX
  package's byte sizes, so ``peak_resident_bytes`` is a function of the
  plan alone and compares across packages.  Admission of the next group
  blocks behind retirement of in-flight groups, and a group whose working
  set cannot fit raises with the live set in the message.  A retired
  group's device tensors (weights, residuals, losses) are released with
  it, so memory on the card is bounded too.
* **Overlap** — the next group's source loads run on a reader thread while
  the current group trains, and entry packing + archival run on the
  :class:`repro_torch.streaming.writer.AsyncArchiveWriter` thread behind a
  bounded queue.  Both threads do host work only; every CUDA call stays on
  the calling thread, in the serial engine's order.  A source whose
  ``load`` itself runs on the device (``loads_on_device = True``, as
  :class:`repro_torch.serve.ArchiveSource`, which decodes) gets no reader
  thread: each of its loads runs on the calling thread.

Training goes through the batched engine's group helpers (whose
strategies give the serial engine's bytes for the groups they accept) and
packing through the serial engine's, so streamed entries equal
``engine="serial"`` entries byte for byte.  (The JAX package's own streamed
entries do not always equal its serial ones; the port is held to its own
serial engine.)
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Mapping

import numpy as np

from .. import device as device_lib
from .. import faults as faults_lib
from ..core import archive as arc_io
from ..core import batched_engine, neurlz
from ..core import bounds as bounds_lib
from ..core import conv_stage as conv_stage_lib
from ..obs import telemetry as obs_lib
from . import source as source_lib
from .writer import AsyncArchiveWriter, EntryTask


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Streaming-only knobs (the budget itself usually comes from
    ``NeurLZConfig.max_resident_bytes``; set it here to override)."""
    max_resident_bytes: int | None = None
    writer_queue: int = 4       # pending entries before put() back-pressures
    depth: int = 2              # dispatched-but-unretired groups in flight
    prefetch: bool = True       # reader-thread lookahead of the next group
    container_version: int = 2  # 2 = durable NLZSTRM2 (checksums + salvage);
    #   1 = legacy NLZSTRM1 byte stream
    durability: str = "none"    # none | flush | fsync — how eagerly sealed
    #   entries reach disk (fsync: an entry survives OS crash, not just
    #   process death)
    checksum: str = "crc32"     # per-record checksum algo (v2): crc32 |
    #   crc32c (needs the optional crc32c wheel)


class ResidencyLedger:
    """Byte accounting for every resident array, with a hard ceiling.

    ``max_bytes <= 0`` disables the ceiling but still tracks the peak.
    """

    def __init__(self, max_bytes: int = 0, telemetry=None):
        self.max_bytes = int(max_bytes)
        self.current = 0
        self.peak = 0
        self._items: dict[str, int] = {}
        self._lock = threading.Lock()
        self.tel = telemetry if telemetry is not None else obs_lib.NULL
        self.tel.gauge("stream.resident_bytes_max").set(self.max_bytes)

    def __contains__(self, key: str) -> bool:
        return key in self._items

    def fits(self, nbytes: int) -> bool:
        return self.max_bytes <= 0 or self.current + nbytes <= self.max_bytes

    def add(self, key: str, nbytes: int) -> None:
        with self._lock:
            self.current += int(nbytes) - self._items.get(key, 0)
            self._items[key] = int(nbytes)
            self.peak = max(self.peak, self.current)
        self.tel.gauge("stream.resident_bytes").set(self.current)

    def drop(self, key: str) -> None:
        with self._lock:
            existed = key in self._items
            self.current -= self._items.pop(key, 0)
        if existed:
            self.tel.counter("stream.evictions").add()
            self.tel.gauge("stream.resident_bytes").set(self.current)


def order_groups(groups, aux_map, metas):
    """Cross-field dependency-aware walk order (greedy, deterministic).

    Score of a candidate group = reconstruction bytes its retirement frees
    minus bytes it must newly materialize; ties fall back to plan order.
    Ordering never changes outputs (entries depend only on their own field,
    its aux reconstructions and the seed), only peak residency.
    """
    names_all = [n for g in groups for n in g.names]
    refs = {n: 1 for n in names_all}
    for n in names_all:
        for a in aux_map.get(n, ()):
            refs[a] = refs.get(a, 0) + 1
    resident: set[str] = set()
    remaining = list(groups)
    order = []

    def score(g):
        need = set()
        drops: dict[str, int] = {}
        for n in g.names:
            need.add(n)
            need.update(aux_map.get(n, ()))
            for m in (n, *aux_map.get(n, ())):
                drops[m] = drops.get(m, 0) + 1
        freed = sum(metas[m].nbytes for m, d in drops.items()
                    if refs[m] - d <= 0)
        new = sum(metas[m].nbytes for m in need if m not in resident)
        return freed - new

    while remaining:
        best = max(range(len(remaining)),
                   key=lambda i: (score(remaining[i]), -i))
        g = remaining.pop(best)
        order.append(g)
        for n in g.names:
            for m in (n, *aux_map.get(n, ())):
                resident.add(m)
                refs[m] -= 1
                if refs[m] <= 0:
                    resident.discard(m)
    return order


class _SnapshotView(dict):
    """Group arrays plus name-membership over the *whole* snapshot, so the
    shared engine helpers can validate cross-field aux names against fields
    that are not resident."""

    def __init__(self, arrays, all_names):
        super().__init__(arrays)
        self._all = frozenset(all_names)

    def __contains__(self, key) -> bool:  # noqa: D105
        return key in self._all


def _dataset_nbytes(meta: source_lib.FieldMeta, c_in: int,
                    slice_axis: int) -> int:
    """float32 training-tensor bytes: inputs [N,H,W,c_in] + targets 1ch."""
    sliced = batched_engine.sliced_shape(meta.shape, slice_axis)
    return int(np.prod(sliced)) * 4 * (c_in + 1)


def _config_signature(config, rel_eb, abs_eb) -> dict:
    """The compatibility fingerprint a resumed run must match: everything
    that changes entry bytes.  Recorded in the v2 prelude, compared before
    salvaged entries are trusted."""
    return {
        "compressor": config.compressor,
        "mode": config.mode,
        "seed": config.seed,
        "epochs": config.epochs,
        "batch": config.batch,
        "lr": config.lr,
        "slice_axis": config.slice_axis,
        "skip": config.skip,
        "learn_residual": config.learn_residual,
        "weight_dtype": config.weight_dtype,
        "widths": list(config.widths),
        "rel_eb": rel_eb,
        "abs_eb": abs_eb,
    }


def _salvage_for_resume(sink, names, sig) -> dict[str, dict]:
    """Pull every intact entry out of a partial container at ``sink`` before
    the fresh :class:`ArchiveAppender` truncates it.

    Returns ``{name: entry}`` for the completed fields (held in memory —
    packed entries are codec-compressed, small next to raw fields).  An
    absent/foreign file resumes as a fresh run; a container written under a
    different config signature or field set is a hard error — silently
    mixing entries from two runs would break the per-entry byte-identity
    contract.
    """
    if not isinstance(sink, (str, bytes, os.PathLike)):
        return {}
    if not (os.path.exists(sink) and os.path.getsize(sink) > 0
            and arc_io.is_streaming_archive(sink)):
        return {}
    out: dict[str, dict] = {}
    with arc_io.ArchiveReader(sink, repair=True) as r:
        pre = r.prelude or {}
        old_sig = pre.get("config_sig")
        if old_sig is not None and sig is not None and old_sig != sig:
            diff = sorted(k for k in sig
                          if old_sig.get(k) != sig.get(k))
            raise ValueError(
                f"resume: partial container at {os.fspath(sink)!r} was "
                f"written under a different configuration (differs in "
                f"{diff}); delete it or rerun with the original settings")
        stale = sorted(set(r.entries) - set(names))
        if stale:
            raise ValueError(
                f"resume: partial container holds fields {stale} that are "
                "not in this snapshot; refusing to mix runs")
        for name in r.entries:
            try:
                entry = r.read_entry(name)
            except arc_io.CorruptArchiveError:
                continue        # torn/corrupt record: recompress that field
            if entry.get("degraded"):
                continue        # give a degraded field another chance
            out[name] = entry
    return out


def _host_tree(tree) -> dict:
    """A parameter tree's device tensors as numpy arrays (the writer
    thread's copy: it packs them without touching the device)."""
    return {n: {k: v.detach().cpu().numpy() for k, v in p.items()}
            for n, p in tree.items()}


def compress(source, sink, rel_eb: float | None = None, *,
             abs_eb: float | None = None, config=None,
             collect_stats: bool = True,
             stream: StreamConfig | None = None, bounds=None,
             resume: bool = False, ledger: ResidencyLedger | None = None,
             device=None) -> dict:
    """Stream-compress a snapshot into an incremental archive container on
    ``device`` (``cuda`` unless given).

    ``source`` is anything :func:`repro_torch.streaming.source.as_source`
    accepts (dict of arrays, ``.npy`` directory, or a
    :class:`ChunkedFieldSource`); ``sink`` is a path or binary file
    object.  ``bounds`` carries per-field
    :class:`repro_torch.core.bounds.ErrorBound` specs (groups are planned
    mode-homogeneous, and the conventional stage batches per bound spec).
    Returns a report dict (timing, peak residency, writer stats).
    Entries are byte-identical to ``engine="serial"`` archives.

    ``resume=True``: when ``sink`` is a path holding a partial container
    from a killed run, every intact entry is salvaged (byte-identical
    re-append), the completed fields are skipped, and only the rest is
    compressed — a crashed streaming run loses at most its in-flight
    group.  The salvaged container must carry a matching config prelude;
    a mismatch is a hard error, never silent mixing.

    ``ledger``: hand in an existing :class:`ResidencyLedger` to share one
    memory ceiling with other subsystems.  When given, the ledger's own
    ``max_bytes`` is the ceiling and ``max_resident_bytes`` from the
    config/stream knobs is ignored; the reported ``peak_resident_bytes``
    then covers everything charged to the shared ledger.  Ledger sharing
    never changes archive bytes — only admission order and peaks.
    """
    config = config or neurlz.NeurLZConfig(engine="streaming")
    config.check()
    stream = stream or StreamConfig()
    device = device_lib.resolve(device)
    tel = obs_lib.of(config)
    fc = faults_lib.of(config)
    budget = (stream.max_resident_bytes
              if stream.max_resident_bytes is not None
              else config.max_resident_bytes)
    if ledger is not None:
        budget = ledger.max_bytes
    t0 = time.perf_counter()
    with tel.span("compress", root=True, engine="streaming") as root_sp:
        with tel.span("plan"):
            src = source_lib.as_source(source)
            names = src.names()
            metas = {n: src.meta(n) for n in names}
            resolved = None
            if bounds is not None:
                resolved = bounds_lib.resolve_bounds(
                    names, bounds, rel_eb, abs_eb, default_mode=config.mode)
            modes = ({n: b.mode for n, b in resolved.items()}
                     if resolved is not None else None)
            aux_map = {n: list(config.cross_field.get(n, ()))
                       for n in names}
            for n, aux in aux_map.items():
                missing = [a for a in aux if a not in metas]
                if missing:
                    raise KeyError(
                        f"cross-field aux {missing} not in input fields")
            c_ins = {n: 1 + len(aux_map[n]) for n in names}
            sig = _config_signature(config, rel_eb, abs_eb)
            # Salvage BEFORE the appender below truncates the sink; the
            # salvaged fields drop out of the group plan entirely (their
            # reconstructions are still conv-compressed on demand when an
            # unfinished field needs them as aux — dependency order holds).
            salvaged: dict[str, dict] = {}
            if resume:
                salvaged = _salvage_for_resume(sink, names, sig)
            remaining = [n for n in names if n not in salvaged]
            groups = batched_engine.plan_groups_from_meta(
                {n: metas[n].shape for n in remaining},
                {n: c_ins[n] for n in remaining}, config,
                modes=({n: modes[n] for n in remaining}
                       if modes is not None else None))
            order = order_groups(groups, aux_map, metas)
        root_sp.set(fields=len(names), groups=len(order),
                    resumed=len(salvaged))

        rec_refs = {n: 1 for n in remaining}
        for n in remaining:
            for a in aux_map[n]:
                rec_refs[a] = rec_refs.get(a, 0) + 1

        # The prelude makes a crashed container self-describing: the
        # salvage scanner and a later resume know the field set and config
        # without ever reaching the (never-written) footer.
        prelude = {
            "field_order": names,
            "shapes": {n: list(metas[n].shape) for n in names},
            "slice_axis": config.slice_axis,
            "compressor": config.compressor,
            "aux": aux_map,
            "config_sig": sig,
        }
        tcfg = config.train_config()
        if ledger is None:
            ledger = ResidencyLedger(budget, telemetry=tel)
        writer = AsyncArchiveWriter(sink, config,
                                    collect_stats=collect_stats,
                                    queue_size=stream.writer_queue,
                                    telemetry=tel, faults=fc,
                                    version=stream.container_version,
                                    durability=stream.durability,
                                    checksum=stream.checksum,
                                    prelude=prelude)
        # Re-append the salvaged entries first, in snapshot field order —
        # msgpack round-trips deterministically, so each re-appended entry
        # is byte-identical to the killed run's (and to a serial run's).
        for n in names:
            if n in salvaged:
                writer.put_entry(n, salvaged[n])
        watchdog = None
        if fc.straggler_deadline_s is not None:
            watchdog = faults_lib.StepWatchdog(
                fc.straggler_deadline_s,
                on_straggler=lambda i: tel.counter("faults.stragglers").add())
        reader = ThreadPoolExecutor(max_workers=1,
                                    thread_name_prefix="neurlz-reader")
        xs: dict[str, np.ndarray] = {}
        conv_arcs: dict[str, dict] = {}
        recs: dict[str, np.ndarray] = {}
        ebs: dict[str, float] = {}
        in_flight: deque = deque()
        # Shared conventional stage: a training group's freshly loaded
        # fields compress as one batched plan under the existing residency
        # ledger (the loaded originals and their reconstructions are
        # already charged).
        stage = conv_stage_lib.ConvStage(config.compressor, rel_eb, abs_eb,
                                         batch=config.conv_batch,
                                         bounds=resolved, device=device,
                                         telemetry=tel)
        want_traces = tel.enabled and tel.config.learning_traces
        # A load that decodes on the device must not leave this thread.
        lookahead = stream.prefetch and not getattr(src, "loads_on_device",
                                                    False)

        def group_cost(group) -> dict[str, int]:
            cost = {}
            for n in group.names:
                xb = metas[n].nbytes
                cost[f"x:{n}"] = xb
                if f"rec:{n}" not in ledger:
                    cost[f"rec:{n}"] = xb
                cost[f"ds:{n}"] = _dataset_nbytes(metas[n], group.c_in,
                                                  config.slice_axis)
            return cost

        def conv_many(arrays: Mapping[str, np.ndarray]) -> None:
            if not arrays:
                return
            # The fused batched path materializes group-sized working
            # copies (float64 casts, the stacked array, code/mask planes);
            # charge an envelope for them so the fused dispatch respects
            # the budget.  If it cannot fit even after retiring in-flight
            # groups, fall back to per-field compression — one field's
            # transients at a time, the historical (uncharged) envelope.
            use_batch = len(arrays) > 1 and config.conv_batch
            if use_batch:
                tmp = 3 * sum(np.asarray(a).size * 8
                              for a in arrays.values())
                while not ledger.fits(tmp) and in_flight:
                    retire(in_flight.popleft())
                if ledger.fits(tmp):
                    ledger.add("convtmp", tmp)
                else:
                    use_batch = False
            try:
                out = stage.run(arrays, batch=use_batch)
            finally:
                ledger.drop("convtmp")
            for name, (arc, rec) in out.items():
                conv_arcs[name], recs[name], ebs[name] = \
                    arc, rec, arc["abs_eb"]

        def unref_rec(name: str) -> None:
            rec_refs[name] -= 1
            if rec_refs[name] <= 0:
                recs.pop(name, None)
                ledger.drop(f"rec:{name}")

        def retire(state) -> None:
            """Wait for the oldest group, enhance and take each field's
            mask, hand host copies of its results to the writer, evict.
            A field whose enhancer failed (injected, non-finite loss,
            out-of-memory) degrades to a conv-only entry, as in the serial
            engine, instead of aborting the snapshot."""
            gcfg = state.config
            tasks: dict[str, EntryTask] = {}
            with tel.span("retire", group=",".join(state.group.names)):
                for f, name, hist, resid in \
                        batched_engine.group_results(state):
                    x = np.asarray(xs[name])
                    reason, mask = None, None
                    try:
                        if fc.degrade and not neurlz.history_is_finite(hist):
                            reason = faults_lib.degrade_reason()
                        else:
                            _, mask = neurlz.enhance_and_mask(
                                x, recs[name], resid, ebs[name], gcfg,
                                state.stats[f])
                            if mask is not None:
                                mask = mask.cpu().numpy()
                    except Exception as exc:
                        if not (fc.degrade and faults_lib.is_degradable(exc)):
                            raise
                        reason = faults_lib.degrade_reason(exc)
                    if reason is not None:
                        tasks[name] = EntryTask(
                            name=name, conv_arc=conv_arcs[name],
                            params=None, stats=[], aux=[], eb=ebs[name],
                            net_cfg=None, history=[], mask=None,
                            mode=state.group.mode, degraded=reason)
                    else:
                        trace = ((neurlz.field_vrange(x), int(x.size))
                                 if want_traces else None)
                        tasks[name] = EntryTask(
                            name=name, conv_arc=conv_arcs[name],
                            params=_host_tree(state.params[f]),
                            stats=state.stats[f], aux=aux_map[name],
                            eb=ebs[name], net_cfg=state.net_cfg,
                            history=hist, mask=mask, mode=state.group.mode,
                            trace=trace)
                for name, exc in state.failed.items():
                    tasks[name] = EntryTask(
                        name=name, conv_arc=conv_arcs[name], params=None,
                        stats=[], aux=[], eb=ebs[name], net_cfg=None,
                        history=[], mask=None, mode=state.group.mode,
                        degraded=faults_lib.degrade_reason(exc))
                # The group's device tensors go with it.
                state.params, state.resids, state.losses = [], [], None
                state.inputs, state.targets = [], []
                for name in state.group.names:
                    writer.put(tasks[name])
                    conv_arcs.pop(name)
                    xs.pop(name, None)
                    ledger.drop(f"x:{name}")
                    ledger.drop(f"ds:{name}")
                    unref_rec(name)
                    for a in aux_map[name]:
                        unref_rec(a)

        def admit(cost: dict[str, int], what: str) -> None:
            need = sum(cost.values())
            while not ledger.fits(need) and in_flight:
                retire(in_flight.popleft())
            if not ledger.fits(need):
                live = sorted(k for k in ledger._items)
                raise MemoryError(
                    f"max_resident_bytes={budget} cannot admit {what} "
                    f"(needs {need} more bytes over {ledger.current} "
                    f"resident: {live}); raise the budget, lower "
                    f"group_size, or wrap the source in BlockedSource")
            for k, v in cost.items():
                ledger.add(k, v)

        def load_field(name: str) -> np.ndarray:
            """Source load under the fault layer: the ``"reader.load"``
            site is probed per attempt and transient I/O errors retry
            under the configured policy."""
            return fc.run(lambda: src.load(name), site="reader.load",
                          tel=tel)

        def ensure_aux_rec(name: str) -> None:
            """Conv-compress an aux producer early (transient load)."""
            if name in recs:
                return
            cost = {f"rec:{name}": metas[name].nbytes,
                    f"tmpx:{name}": metas[name].nbytes}
            admit(cost, f"aux reconstruction of {name!r}")
            conv_many({name: load_field(name)})
            ledger.drop(f"tmpx:{name}")

        def prefetch_load(group):
            # Runs on the reader thread: its "read" span has no enclosing
            # span there, so it parents to the run's root span.
            with tel.span("read", group=",".join(group.names)):
                return {n: load_field(n) for n in group.names}

        prefetched = None           # (group, future, cost) for order[i+1]
        t_train0 = time.perf_counter()
        conv_before = stage.stats.conv_s
        try:
            for gi, group in enumerate(order):
                straggle = (watchdog.step(gi) if watchdog is not None
                            else contextlib.nullcontext())
                with straggle:
                    if prefetched is not None and prefetched[0] is group:
                        arrays = prefetched[1].result()
                    else:
                        admit(group_cost(group), f"group {group.names}")
                        with tel.span("load", group=",".join(group.names)):
                            arrays = {n: load_field(n) for n in group.names}
                    prefetched = None
                    xs.update(arrays)
                    # Conv-compress the group's own fields first (fused,
                    # from the already-loaded arrays) so an in-group aux
                    # producer never takes the transient-reload path below.
                    conv_many({n: xs[n] for n in group.names
                               if n not in recs})
                    for name in group.names:
                        for a in aux_map[name]:
                            ensure_aux_rec(a)
                    with tel.span("train", group=",".join(group.names)):
                        state = batched_engine._prepare_group(
                            group,
                            _SnapshotView({n: xs[n] for n in group.names},
                                          names),
                            recs, ebs, config, tcfg, device)
                        batched_engine._dispatch_group(state, config, tcfg,
                                                       device, fc)
                in_flight.append(state)
                del state
                # Retire down to depth BEFORE prefetching: steady-state
                # residency is then depth working sets, so a budget of ~2
                # group working sets still gets reader-thread lookahead.
                while len(in_flight) > max(1, stream.depth) - 1:
                    retire(in_flight.popleft())
                # Reader-thread lookahead: load the next group's originals
                # while this group trains on device (skipped, not blocked,
                # when the budget cannot take both working sets at once).
                if gi + 1 < len(order) and lookahead:
                    nxt = order[gi + 1]
                    cost = group_cost(nxt)
                    if ledger.fits(sum(cost.values())):
                        for k, v in cost.items():
                            ledger.add(k, v)
                        fut = reader.submit(prefetch_load, nxt)
                        prefetched = (nxt, fut, cost)
            while in_flight:
                retire(in_flight.popleft())
            train_time = (time.perf_counter() - t_train0) \
                - (stage.stats.conv_s - conv_before)

            # Drain the writer queue before building timing: degradation
            # decisions are made at pack time on the writer thread, and the
            # footer's timing must already list them.
            writer.drain()
            timing = obs_lib.build_timing(
                tel, total_s=time.perf_counter() - t0,
                conv_s=stage.stats.conv_s, train_s=train_time,
                conv_stage=stage.stats.as_dict(),
                peak_resident_bytes=ledger.peak,
                max_resident_bytes=budget,
                degraded_fields=list(writer.degraded),
                resumed_fields=sorted(salvaged), device=str(device))
            if watchdog is not None:
                timing["straggler_overruns"] = len(watchdog.overruns)
            meta = {
                "field_order": names,
                "shapes": {n: list(metas[n].shape) for n in names},
                "slice_axis": config.slice_axis,
                "compressor": config.compressor,
                "aux": aux_map,
                "blocks": dict(getattr(src, "manifest", {}) or {}),
                "timing": timing,
            }
            with tel.span("flush"):
                stats = writer.close(meta)
            timing["total_s"] = time.perf_counter() - t0
            if tel.enabled:
                # Refresh: the writer thread's spans land during close().
                timing["spans"] = tel.span_summary()
            return {**timing, **stats, "field_order": names,
                    "groups": len(order)}
        except BaseException:
            writer.abort()
            raise
        finally:
            if prefetched is not None:
                prefetched[1].cancel()
            reader.shutdown(wait=True)
            in_flight.clear()
            # Release every charge this run still holds — on the success
            # path they are already gone, but an aborted run sharing an
            # external ledger must not leave phantom bytes pinned against
            # another subsystem's ceiling.
            for k in list(ledger._items):
                if k.startswith(("x:", "rec:", "ds:", "tmpx:", "convtmp")):
                    ledger.drop(k)


class PipelineScheduler:
    """Configured handle over the streaming scheduler.

    Holds the ``NeurLZConfig`` + :class:`StreamConfig` pair (and the
    device) so repeated snapshots (e.g. successive simulation timesteps)
    run with one budget:

        sched = PipelineScheduler(cfg, StreamConfig())
        for step, src in snapshots:
            report = sched.run(src, f"snap_{step}.nlzs", rel_eb=1e-3)
    """

    def __init__(self, config=None, stream: StreamConfig | None = None, *,
                 device=None):
        self.config = config or neurlz.NeurLZConfig(engine="streaming")
        self.stream = stream or StreamConfig()
        self.device = device_lib.resolve(device)

    def run(self, source, sink, rel_eb: float | None = None, *,
            abs_eb: float | None = None, collect_stats: bool = True,
            bounds=None, resume: bool = False,
            ledger: ResidencyLedger | None = None) -> dict:
        return compress(source, sink, rel_eb, abs_eb=abs_eb,
                        config=self.config, collect_stats=collect_stats,
                        stream=self.stream, bounds=bounds, resume=resume,
                        ledger=ledger, device=self.device)


def compress_dict(fields, rel_eb: float | None = None, *,
                  abs_eb: float | None = None, config=None,
                  collect_stats: bool = True, bounds=None,
                  device=None) -> dict:
    """``engine="streaming"`` entry point of
    :func:`repro_torch.core.neurlz.compress_impl`: run the full pipeline
    (scheduler, budget, writer thread) against an in-memory sink, then
    reassemble the whole-dict archive contract."""
    buf = io.BytesIO()
    report = compress(fields, buf, rel_eb, abs_eb=abs_eb, config=config,
                      collect_stats=collect_stats, bounds=bounds,
                      device=device)
    buf.seek(0)
    with arc_io.ArchiveReader(buf) as r:
        arc = neurlz.assemble_streaming_archive(r)
    arc["timing"] = {**arc["timing"],
                     **{k: report[k] for k in
                        ("writer_busy_s", "writer_put_wait_s",
                         "writer_close_wait_s", "bytes_written", "entries",
                         "spans")
                        if k in report}}
    return arc


# ---------------------------------------------------------------------------
# Streaming decode: one field at a time from the incremental container
# ---------------------------------------------------------------------------

def iter_decompress(source, *, reassemble: bool = True, device=None):
    """Yield ``(name, array)`` one field at a time from a streaming
    container (a path, a binary file object or an open
    :class:`repro_torch.Archive`, whose device, telemetry and faults it
    then uses; else it decodes on ``device``, ``cuda`` unless given).

    Only the reconstructions still needed as cross-field aux stay resident
    (same refcounting as the encoder), so decode memory is bounded by the
    largest field plus its live aux set.  A field's conventional decode
    and those of its not-yet-resident aux producers run as one
    ``decompress_many`` call (archives that share a decode key in one
    stacked call).  With ``reassemble=True`` (the default), blocks written
    through :class:`BlockedSource` are concatenated back into their
    original fields before being yielded.
    """
    from ..core.archive_api import Archive
    own = not isinstance(source, Archive)
    arc = Archive.open(source, device=device) if own else source
    try:
        if not arc.streaming:
            raise ValueError("iter_decompress reads a streaming container; "
                             "decode a whole-dict archive with decode_all")
        order = arc.field_names
        aux_map = arc.meta.get("aux") or {}
        blocks = arc.block_manifest
        block_owner = {bname: orig for orig, man in blocks.items()
                       for bname, _, _ in man["blocks"]}
        refs = {n: 1 for n in order}
        for n in order:
            for a in aux_map.get(n, ()):
                refs[a] = refs.get(a, 0) + 1
        recs: dict[str, np.ndarray] = {}
        pending: dict[str, dict[str, np.ndarray]] = {}
        for name in order:
            out, aux = arc._decode(name, recs)
            for m in (name, *aux):
                refs[m] = refs.get(m, 1) - 1
                if refs[m] <= 0:
                    recs.pop(m, None)
            if reassemble and name in block_owner:
                orig = block_owner[name]
                man = blocks[orig]
                pending.setdefault(orig, {})[name] = out
                if len(pending[orig]) == len(man["blocks"]):
                    parts = [pending[orig][bn] for bn, _, _ in man["blocks"]]
                    yield orig, np.concatenate(parts, axis=man["axis"])
                    del pending[orig]
            else:
                yield name, out
    finally:
        if own:
            arc.close()


def decompress(source, *, reassemble: bool = True,
               device=None) -> dict[str, np.ndarray]:
    """Materialize :func:`iter_decompress` into a dict (field order of the
    snapshot, block-reassembled by default)."""
    return dict(iter_decompress(source, reassemble=reassemble, device=device))
