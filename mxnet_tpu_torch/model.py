"""Checkpoint helpers (counterpart of ``mxnet_tpu/model.py``; ref:
python/mxnet/model.py :: save_checkpoint / load_checkpoint,
``prefix-####.params``).

Checkpoint writes run asynchronously on the native dependency engine
(``engine.native_engine``): ``save_checkpoint`` snapshots the parameters
and returns while a worker writes the file. One engine var orders every
checkpoint write, so a load after a save in the same process reads what
was saved, and a failed write re-raises at the next
:func:`wait_checkpoints` (the engine's error-at-wait contract); the first
asynchronous save registers an exit drain, so an error in a run's last
write is not lost at exit. ``sync=True`` blocks.

The snapshot. The reference's arrays are immutable, so it keeps the
buffers as they are; the port's optimizers (and the fused SGD graph)
write the weights in place. ``save_checkpoint`` therefore copies every
array on its device before it returns, on the current stream, so the
copy is ordered before any later update, and the writer waits for an
event recorded after the copies. A file saved at step k holds step k's
weights, whatever steps follow.

Crash safety: the file lands in a temp file renamed into place, so a
kill in the middle never publishes a truncated ``.params``; each write
records its file, epoch, size and sha256 in ``<prefix>-manifest.json``
(itself replaced atomically); :func:`load_latest_checkpoint` walks the
manifest newest first, checks each checksum and falls back past a
corrupt or missing file. ``states_blob`` is written beside it as
``<prefix>-####.states`` under the same scheme, and retention
(``max_keep``, ``MXNET_CKPT_KEEP``) prunes both. The ``ckpt_write`` fault
site cuts the temp file to half and fails the write.

A ``sharding`` section rides the manifest entry
(:func:`checkpoint_sharding`); building one (``reshard.sharding_manifest``)
waits with ``parallel/reshard.py`` (ROADMAP.md queue 1, item 11). What
waits for later items raises: a ``symbol`` other than None and
:func:`load_checkpoint`'s symbol (item 16).
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from collections import namedtuple

from . import ndarray as nd
from . import telemetry
from .base import MXNetError
from .context import cpu

__all__ = ["save_checkpoint", "load_checkpoint", "load_params",
           "load_latest_checkpoint", "wait_checkpoints", "checkpoint_entry",
           "load_checkpoint_states", "checkpoint_sharding",
           "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])

_CKPT_VAR = [None]     # one engine var orders checkpoint writes


def _not_ported(what, item):
    return NotImplementedError("%s is not ported yet (ROADMAP.md queue 1, "
                               "item %d)" % (what, item))


def _native():
    """The native engine, or None where it cannot be built (the writes
    then run synchronously, as the reference's do without one)."""
    from .engine import native_engine
    try:
        return native_engine()
    except MXNetError:
        return None


def _ckpt_var(eng):
    if _CKPT_VAR[0] is None:
        _CKPT_VAR[0] = eng.new_var()
    return _CKPT_VAR[0]


def wait_checkpoints():
    """Block until every pending checkpoint write landed; re-raises the
    first write error."""
    if _CKPT_VAR[0] is not None:
        from . import engine
        if engine._NATIVE is not None:
            engine._NATIVE.wait_for_var(_CKPT_VAR[0])


_EXIT_DRAIN = [False]


def _register_exit_drain():
    """The first asynchronous save registers a drain at exit: an error
    in the last write of a run raises then, not never."""
    if _EXIT_DRAIN[0]:
        return
    _EXIT_DRAIN[0] = True
    import atexit
    atexit.register(wait_checkpoints)


# ---------------------------------------------------------------------------
# the manifest and integrity
# ---------------------------------------------------------------------------
def _sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _manifest_path(prefix):
    return "%s-manifest.json" % prefix


def _read_manifest(prefix):
    """The manifest, or None when absent or unreadable (then the files
    are found by name)."""
    try:
        with open(_manifest_path(prefix), "r") as f:
            man = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(man, dict) or \
            not isinstance(man.get("checkpoints"), list):
        return None
    return man


def _write_manifest(prefix, man):
    path = _manifest_path(prefix)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(man, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# the reference's manifest version: v2 entries may carry a "states"
# sidecar and a "sharding" section
_MANIFEST_VERSION = 2


def _update_manifest(prefix, epoch, fname, digest, size, max_keep,
                     extra=None):
    """Record a landed checkpoint; prune past the retention window (the
    pruned files deleted)."""
    man = _read_manifest(prefix) or {"checkpoints": []}
    man["version"] = _MANIFEST_VERSION
    entries = [c for c in man["checkpoints"]
               if isinstance(c, dict) and c.get("epoch") != epoch]
    entry = {"epoch": epoch, "file": os.path.basename(fname),
             "sha256": digest, "size": size, "time": time.time()}
    if extra:
        entry.update(extra)
    entries.append(entry)
    entries.sort(key=lambda c: c.get("epoch", -1))
    pruned = []
    if max_keep and max_keep > 0 and len(entries) > max_keep:
        pruned, entries = entries[:-max_keep], entries[-max_keep:]
    man["checkpoints"] = entries
    _write_manifest(prefix, man)
    ckpt_dir = os.path.dirname(prefix)
    for c in pruned:
        for key in ("file", "states"):
            if not c.get(key):
                continue
            try:
                os.remove(os.path.join(ckpt_dir, c[key]))
            except OSError:
                pass


def _snapshot(arrays):
    """Copies of ``arrays`` (a dict of NDArrays) on their devices, and
    the event after them on each card (None on the CPU)."""
    import torch
    snap, events = {}, []
    with torch.no_grad():
        for k, v in arrays.items():
            t = v.tensor().detach()
            snap[k] = nd.NDArray(t.clone(), v.context)
            if t.is_cuda and not events:
                events.append(torch.cuda.Event())
    for ev in events:
        ev.record()
    return snap, events


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True, sync=False, max_keep=None,
                    sharding=None, states_blob=None):
    """Snapshot the parameters and write ``<prefix>-<epoch>.params``
    (keys ``arg:<name>``/``aux:<name>``, the reference's format) crash
    safely, with its manifest entry; ``states_blob`` (bytes) goes to
    ``<prefix>-<epoch>.states`` beside it. ``max_keep`` bounds the
    retention window (default ``MXNET_CKPT_KEEP``; 0 keeps all).
    ``sharding`` (the logical-sharding section, a JSON-able dict) rides
    the manifest entry, as in the reference (:func:`checkpoint_sharding`
    reads it back)."""
    if symbol is not None:
        raise _not_ported("save_checkpoint with a symbol", 16)
    named = {("arg:%s" % k): v for k, v in arg_params.items()}
    named.update({("aux:%s" % k): v for k, v in aux_params.items()})
    snap, events = _snapshot(named)
    param_name = "%s-%04d.params" % (prefix, epoch)
    states_name = "%s-%04d.states" % (prefix, epoch)
    if max_keep is None:
        from .config import get as _cfg
        max_keep = _cfg("MXNET_CKPT_KEEP")

    def write():
        from . import faultinject
        for ev in events:
            ev.synchronize()      # the copies are done
        tmp = "%s.tmp.%d" % (param_name, os.getpid())
        stmp = "%s.tmp.%d" % (states_name, os.getpid())
        extra = {}
        if sharding is not None:
            extra["sharding"] = sharding
        try:
            with telemetry.span("checkpoint::write", "checkpoint",
                                hist="mx_checkpoint_write_seconds"):
                nd.save(tmp, snap)
                if states_blob is not None:
                    with open(stmp, "wb") as f:
                        f.write(states_blob)
                        f.flush()
                        os.fsync(f.fileno())
                if faultinject.should_fail("ckpt_write"):
                    # a crash in the middle of the write: the temp file
                    # cut, nothing published, the error at the wait
                    with open(tmp, "r+b") as f:
                        f.truncate(max(0, os.path.getsize(tmp) // 2))
                    raise MXNetError("injected fault: checkpoint write "
                                     "failed (ckpt_write)")
                digest = _sha256_file(tmp)
                size = os.path.getsize(tmp)
                if states_blob is not None:
                    extra["states"] = os.path.basename(states_name)
                    extra["states_sha256"] = _sha256_file(stmp)
                    extra["states_size"] = os.path.getsize(stmp)
                    os.replace(stmp, states_name)
                os.replace(tmp, param_name)
        except BaseException:
            telemetry.checkpoint_event(ok=False)
            for t in (tmp, stmp):
                try:
                    os.remove(t)
                except OSError:
                    pass
            raise
        telemetry.checkpoint_event(ok=True)
        _update_manifest(prefix, epoch, param_name, digest, size,
                         max_keep, extra=extra or None)

    eng = _native()
    if eng is None:
        write()
        return
    _register_exit_drain()
    eng.push_async(write, write_vars=(_ckpt_var(eng),),
                   label="checkpoint_write:%s"
                         % os.path.basename(param_name))
    if sync:
        wait_checkpoints()


def _load_params_file(fname):
    """``nd.load`` (on the CPU) split into arg and aux dicts; a file
    that does not parse raises MXNetError naming it."""
    try:
        save_dict = nd.load(fname, ctx=cpu())
    except FileNotFoundError:
        raise
    except MXNetError:
        raise
    except Exception as e:
        raise MXNetError(
            "corrupt or truncated parameter file %r (%s: %s) — the write "
            "likely died mid-flight; use load_latest_checkpoint() to fall "
            "back to the newest valid checkpoint"
            % (fname, type(e).__name__, e))
    if not isinstance(save_dict, dict):
        raise MXNetError(
            "parameter file %r does not hold a name->NDArray dict (got "
            "%s) — not a save_checkpoint output"
            % (fname, type(save_dict).__name__))
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        if ":" not in k:
            raise MXNetError(
                "malformed key %r in parameter file %r (expected "
                "'arg:<name>' / 'aux:<name>') — file is corrupt or not a "
                "checkpoint" % (k, fname))
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def load_params(prefix, epoch):
    """``(arg_params, aux_params)`` of one epoch, on the CPU, after any
    write in flight."""
    wait_checkpoints()
    return _load_params_file("%s-%04d.params" % (prefix, epoch))


def load_checkpoint(prefix, epoch):
    """The reference returns the symbol too; the port traces no Symbol
    graph yet."""
    raise _not_ported("load_checkpoint's symbol", 16)


def _candidate_checkpoints(prefix):
    """(epoch, path, sha256 or None), newest first: the manifest's, or
    without one the ``<prefix>-NNNN.params`` files."""
    man = _read_manifest(prefix)
    ckpt_dir = os.path.dirname(prefix)
    if man is not None:
        out = []
        for c in man["checkpoints"]:
            if not isinstance(c, dict) or "file" not in c:
                continue
            out.append((int(c.get("epoch", -1)),
                        os.path.join(ckpt_dir, c["file"]),
                        c.get("sha256")))
        out.sort(key=lambda t: -t[0])
        return out
    import glob
    import re
    pat = re.compile(re.escape(os.path.basename(prefix)) +
                     r"-(\d{4,})\.params$")
    out = []
    for path in glob.glob("%s-*.params" % prefix):
        m = pat.match(os.path.basename(path))
        if m:
            out.append((int(m.group(1)), path, None))
    out.sort(key=lambda t: -t[0])
    return out


def load_latest_checkpoint(prefix):
    """The newest checkpoint that exists, passes its checksum and
    parses: ``(arg_params, aux_params, epoch)``, or None."""
    wait_checkpoints()
    for epoch, path, digest in _candidate_checkpoints(prefix):
        if not os.path.exists(path):
            continue
        if digest is not None and _sha256_file(path) != digest:
            logging.warning(
                "checkpoint %s fails its manifest checksum (truncated or "
                "corrupt write) — falling back to an older checkpoint",
                path)
            continue
        try:
            arg_params, aux_params = _load_params_file(path)
        except (MXNetError, OSError) as e:
            logging.warning("checkpoint %s unreadable (%s) — falling back "
                            "to an older checkpoint", path, e)
            continue
        return arg_params, aux_params, epoch
    return None


def checkpoint_entry(prefix, epoch):
    """The manifest entry of one epoch, or None."""
    man = _read_manifest(prefix)
    if man is None:
        return None
    for c in man["checkpoints"]:
        if isinstance(c, dict) and c.get("epoch") == epoch:
            return c
    return None


def checkpoint_sharding(prefix, epoch):
    """The logical-sharding section of one checkpoint's manifest entry,
    or None (none written: a replicated layout of unknown topology)."""
    entry = checkpoint_entry(prefix, epoch)
    return entry.get("sharding") if entry else None


def load_checkpoint_states(prefix, epoch):
    """The optimizer-state sidecar of one epoch, checked against its
    checksum, or None (none written, or corrupt: then with a warning,
    and the caller restores the parameters only)."""
    wait_checkpoints()
    entry = checkpoint_entry(prefix, epoch)
    if not entry or not entry.get("states"):
        return None
    path = os.path.join(os.path.dirname(prefix), entry["states"])
    try:
        if entry.get("states_sha256") and \
                _sha256_file(path) != entry["states_sha256"]:
            logging.warning(
                "optimizer-state sidecar %s fails its manifest checksum "
                "— restoring params only", path)
            return None
        with open(path, "rb") as f:
            return f.read()
    except OSError as e:
        logging.warning("optimizer-state sidecar %s unreadable (%s) — "
                        "restoring params only", path, e)
        return None
