"""The tuning database: CRC'd JSONL, rewritten by atomic rename.

Counterpart of ``mxnet_tpu/autotune/db.py``, byte for byte in its
format: each line is ``{"crc": crc32(payload), "payload": json}``, a
rewrite goes tmp file, fsync, ``os.replace``, directory fsync, and a
reader takes any malformed line (a torn tail, bit-rot, another schema
version) as absent, with one ``tune_db_fallback`` event a load, never as
a crash.  A rewrite drops such lines.

Location: ``MXTPU_TUNE_DB``, else ``tune_db.jsonl`` in
``MXTPU_COMPILE_CACHE_DIR``; neither set means no persistence (a search
still runs, its winner is not replayable).

Entries are keyed by (capture signature, device kind, mesh shape); the
port's device kind is the card's name (``torch.cuda.get_device_name``),
so an entry tuned on a TPU, or on the host, never replays on the card.
"""

from __future__ import annotations

import json
import os
import zlib

DB_VERSION = 1


def tune_db_path():
    """The database file path, or None when persistence is off."""
    p = os.environ.get("MXTPU_TUNE_DB")
    if p:
        return p
    cache = os.environ.get("MXTPU_COMPILE_CACHE_DIR")
    if cache:
        return os.path.join(cache, "tune_db.jsonl")
    return None


def entry_key(signature, device_kind, mesh_shape):
    """The DB key string.  ``signature`` is the trainer's stable
    capture signature, ``mesh_shape`` a ((axis, size), ...) tuple or
    None."""
    mesh = "x".join(f"{a}={n}" for a, n in (mesh_shape or ()))
    return f"{signature}|{device_kind}|{mesh or 'single'}"


def _encode(entry):
    """One JSONL line: the payload json plus a trailing CRC32 of the
    payload bytes (the checkpoint-manifest discipline, readable by eye
    and by `zlib.crc32`)."""
    payload = json.dumps(entry, sort_keys=True, separators=(",", ":"))
    crc = zlib.crc32(payload.encode()) & 0xFFFFFFFF
    return json.dumps({"crc": crc, "payload": payload},
                      separators=(",", ":")) + "\n"


def _decode(line):
    """The entry dict, or None for any malformed/torn/corrupt line."""
    try:
        outer = json.loads(line)
        payload = outer["payload"]
        if zlib.crc32(payload.encode()) & 0xFFFFFFFF != outer["crc"]:
            return None
        entry = json.loads(payload)
        return entry if isinstance(entry, dict) else None
    except (ValueError, KeyError, TypeError):
        return None


def load(path=None):
    """{key: entry} of every valid current-version entry (later lines
    win).  Corrupt/torn lines and stale-version entries are skipped
    with ONE ``tune_db_fallback`` telemetry event per load — the run
    continues at defaults, it never crashes on its own database."""
    from .. import telemetry

    path = path or tune_db_path()
    entries = {}
    bad = stale = 0
    if path is None or not os.path.exists(path):
        return entries
    try:
        with open(path, encoding="utf-8") as f:
            lines = f.readlines()
    except OSError:
        telemetry.event("tune_db_fallback", reason="unreadable",
                        path=path)
        return entries
    for line in lines:
        if not line.strip():
            continue
        entry = _decode(line)
        if entry is None:
            bad += 1
            continue
        if entry.get("db_version") != DB_VERSION:
            stale += 1
            continue
        key = entry.get("key")
        if key:
            entries[key] = entry
    if bad or stale:
        telemetry.event("tune_db_fallback", path=path,
                        corrupt_entries=bad, stale_entries=stale)
    return entries


def lookup(key, path=None):
    """The stored entry for ``key``, or None."""
    return load(path).get(key)


def record(key, config, score_us, path=None, mfu=None, trials=None,
           default_score_us=None):
    """Upsert the winning ``config`` for ``key`` and atomically rewrite
    the database.  The rewrite GCs corrupt and stale-version entries as
    a side effect (they simply aren't carried over).  Returns the
    entry, or None when persistence is off."""
    import time

    from .. import resilience, telemetry
    from . import space

    path = path or tune_db_path()
    if path is None:
        return None
    entries = load(path)
    entry = {
        "db_version": DB_VERSION,
        "key": key,
        "config": {k: str(v) for k, v in config.items()},
        "fingerprint": space.fingerprint(config),
        "score_us": float(score_us),
        "t": time.time(),
    }
    if mfu is not None:
        entry["mfu"] = float(mfu)
    if trials is not None:
        entry["trials"] = int(trials)
    if default_score_us is not None:
        entry["default_score_us"] = float(default_score_us)
    entries[key] = entry
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        for k in sorted(entries):
            line = _encode(entries[k])
            if k == key and resilience.consume_fault("corrupt_tune_db"):
                # injected bit-rot: flip a byte mid-payload so the CRC
                # check must catch it on the next load
                mid = len(line) // 2
                line = line[:mid] + ("X" if line[mid] != "X" else "Y") \
                    + line[mid + 1:]
            f.write(line)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass
    telemetry.event("tune_db_write", key=key,
                    fingerprint=entry["fingerprint"],
                    score_us=entry["score_us"])
    return entry
