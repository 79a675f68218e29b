"""Integrity plane: silent-data-corruption detection, cross-replica
state attestation and corrupt-rank quarantine.

Counterpart of ``mxnet_tpu/integrity.py``, all of it, with the same
fingerprint: a flipped bit in a parameter, a defective core, a replica
whose state drifted all keep reporting "healthy" while training
diverges.  Replicas of a captured step are bitwise equal by
construction, so any fingerprint mismatch among them is corruption, and
a deterministic re-run of a step is a ground-truth oracle.

- Tier 1, attestation (``IntegrityPlane.attest``): every
  ``MXTPU_INTEGRITY_EVERY`` (default 50) steps each rank publishes a
  fingerprint of its parameters and optimizer states at
  ``integrity/<epoch>/<step>/<rank>`` on the gang KV, and the peers that
  must be bitwise equal vote: the majority is truth.  The captured step
  computes the fingerprint on the card in a pass of its own after the
  replay, on due steps only (``fingerprint_arrays``), and its two words
  ride the step guard's one readback.
- Tier 2, shadow replay (``retain`` / ``audit``): re-run the retained
  pre-step state and compare: replay != live is ``"memory"`` (a bit
  flip), replay == live while peers disagree is ``"compute"``.
- Tier 3, the lineage ledger (``IntegrityLedger``): each attestation is
  hash-chained in a JSONL ledger; ``checkpoint.AsyncCheckpointer`` stamps
  the chain head into MANIFEST.json and restore checks it
  (``verify_provenance``).

The fingerprint: each leaf is read as 32-bit words (a 4-byte element is
one word, a 2-byte or 1-byte element is zero-extended to one, a bool is
0 or 1, an 8-byte element is its low word then its high word), and
folded as ``sum(word[i] * (2*i+1) * salt(leaf))`` into two mod-2^32
accumulators with independent per-leaf salts.  The odd weights make any
single-bit flip change the sum.  The card computes it in int64 with
masks (CUDA has no uint32 arithmetic to rely on), a large leaf in
chunks (the sum mod 2^32 does not depend on the order), and equals the
numpy mirror (``fingerprint_host``) and the JAX package's fingerprint
bitwise.  Leaves are taken in ``jax.tree_util.tree_leaves``'s order:
dict keys sorted, ``None`` is no leaf.

Environment: ``MXTPU_INTEGRITY`` (default off), ``MXTPU_INTEGRITY_EVERY``
(50), ``MXTPU_INTEGRITY_LEDGER`` (ledger path), ``MXTPU_INTEGRITY_TIMEOUT``
(peer wait, 5 s).  Fault sites: ``bit_flip_param:K`` / ``bit_flip_grad:K``
(flip one bit on rank K) and ``bad_core:K`` (rank K computes a
deterministically wrong answer).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time

from .base import MXNetError

_SALT_LO = 0x9E3779B1   # odd golden-ratio constants: per-leaf salts
_SALT_HI = 0x85EBCA77   # stay odd (odd * odd), hence invertible
_MASK32 = 0xFFFFFFFF


# -- env plumbing --------------------------------------------------------------

def enabled() -> bool:
    """MXTPU_INTEGRITY gate (default off): when on, the captured step
    fingerprints the state on due steps and the Trainer attests on the
    plane attached with ``Trainer.attach_integrity``."""
    return os.environ.get("MXTPU_INTEGRITY", "").lower() \
        in ("1", "true", "on", "yes")


def fingerprint_enabled() -> bool:
    """Alias read by ``gluon.captured.get_step``: the flag joins the
    capture key, as the JAX package's does (there a toggled value
    changes the program's outputs)."""
    return enabled()


def attest_every(default=50) -> int:
    """MXTPU_INTEGRITY_EVERY: attestation period in steps."""
    try:
        v = int(os.environ.get("MXTPU_INTEGRITY_EVERY", default))
    except ValueError:
        v = default
    return max(1, v)


def peer_timeout(default=5.0) -> float:
    """MXTPU_INTEGRITY_TIMEOUT: how long `attest` waits for layout-mate
    fingerprints before voting on what arrived."""
    try:
        v = float(os.environ.get("MXTPU_INTEGRITY_TIMEOUT", default))
    except ValueError:
        v = default
    return max(0.0, v)


def ledger_path():
    """Ledger location: MXTPU_INTEGRITY_LEDGER when set, else
    ``integrity_ledger.jsonl`` next to the tuning DB (the MXTPU_TUNE_DB
    dir, or MXTPU_COMPILE_CACHE_DIR), else None (ledger off: attestation
    still works, provenance stamping does not)."""
    p = os.environ.get("MXTPU_INTEGRITY_LEDGER")
    if p:
        return p
    db = os.environ.get("MXTPU_TUNE_DB")
    if db:
        return os.path.join(os.path.dirname(db) or ".",
                            "integrity_ledger.jsonl")
    cache = os.environ.get("MXTPU_COMPILE_CACHE_DIR")
    if cache:
        return os.path.join(cache, "integrity_ledger.jsonl")
    return None


def self_rank(default=0) -> int:
    """This process's fleet rank (MXTPU_WORKER_RANK, the launch.py
    identity every other subsystem keys on): what the rank-targeted
    SDC fault sites compare against when no gang rank is supplied."""
    try:
        return int(os.environ.get("MXTPU_WORKER_RANK", default))
    except ValueError:
        return default


def _tel_event(name, /, **fields):
    """Telemetry event; the name is positional-only so a ``kind`` detail
    field passes through."""
    from . import telemetry

    telemetry.event(name, **fields)


def _tel_integrity(**fields):
    from . import telemetry

    telemetry.integrity_record(**fields)


# -- fingerprint math ----------------------------------------------------------

#: words of one pass: a larger leaf is fingerprinted in chunks, and small
#: leaves of one word width are concatenated up to this many words
CHUNK_WORDS = 1 << 24
_BIG_INDEX = 1 << 30     # from here 2*i+1 no longer fits 31 bits


def _salts(j):
    lo = (_SALT_LO * (2 * j + 1)) & _MASK32
    hi = (_SALT_HI * (2 * j + 1)) & _MASK32
    return lo, hi


def _leaves(tree):
    """``jax.tree_util.tree_leaves``'s order without JAX: dict values by
    sorted key, list and tuple items in order, ``None`` no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaves(tree[k]))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for v in tree:
            out.extend(_leaves(v))
        return out
    return [tree]


def _mulmod32(a, b):
    """``(a * b) mod 2^32`` of int64 tensors with ``0 <= a, b < 2^32``,
    without overflowing int64: ``b`` in two 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _word_source(t):
    """(flat tensor of one word width, kind) for a tensor's words: int32
    for 4- and 8-byte elements (an 8-byte element is its low word, then
    its high word), int16 for 2-byte ones (bf16 included), uint8 for
    1-byte ones and bools (stored as 0 or 1)."""
    import torch

    t = t.detach().reshape(-1)
    if t.dtype == torch.bool:
        return t.view(torch.uint8), "u8"
    size = t.element_size()
    if size in (4, 8):
        return t.view(torch.int32), "i32"
    if size == 2:
        return t.view(torch.int16), "i16"
    if size == 1:
        return t.view(torch.uint8), "u8"
    raise MXNetError(f"integrity: no fingerprint for dtype {t.dtype}")


_ODD = {}       # device -> cached 2*arange(n)+1 (int64)


def _odd(n, device):
    """``2*arange(n)+1`` (int64) on ``device``, from a per-device cache."""
    import torch

    key = str(device)
    odd = _ODD.get(key)
    if odd is None or odd.numel() < n:
        odd = _ODD[key] = torch.arange(
            max(n, 1), dtype=torch.int64, device=device).mul_(2).add_(1)
    return odd[:n]


def _as_tensor(a, device):
    """A leaf as a tensor on ``device`` holding the same words."""
    import numpy as np
    import torch

    a = getattr(a, "_data", a)
    if isinstance(a, torch.Tensor):
        return a.to(device) if a.device != device else a
    arr = np.ascontiguousarray(np.asarray(a))
    if arr.dtype.kind not in "biuf":
        # ml_dtypes' bfloat16 (a JAX-written leaf) and the like: its words
        arr = arr.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                        8: np.uint64}[arr.dtype.itemsize])
    signed = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
              np.dtype(np.uint64): np.int64}.get(arr.dtype)
    if signed is not None:
        arr = arr.view(signed)
    return torch.from_numpy(arr).to(device)


def fingerprint_arrays(arrs, chunk=None):
    """The fingerprint of a list of tensors (numpy leaves are taken to the
    first tensor's device) as a ``(2,)`` int64 tensor ``[lo, hi]`` on
    that device; nothing is read back.  ``combine`` folds it into the u64
    that ``fingerprint_host`` returns.

    Per leaf ``j``: ``S_j = sum_i ((word_i * (2*i+1)) mod 2^32)`` in int64
    (below 2^63 while a pass covers fewer than 2^30 words), then
    ``lo = sum_j S_j * salt_lo(j)`` and ``hi`` likewise, mod 2^32.  Leaves
    of one word width are concatenated into passes of up to ``chunk``
    (``CHUNK_WORDS``) words; a larger leaf runs in chunks that carry their
    index offset."""
    import torch

    chunk = int(chunk or CHUNK_WORDS)
    arrs = list(arrs)
    device = next((getattr(a, "_data", a).device for a in arrs
                   if isinstance(getattr(a, "_data", a), torch.Tensor)),
                  torch.device("cpu"))
    passes = {"i32": [], "i16": [], "u8": []}    # kind -> [[words, segs]]
    for j, a in enumerate(arrs):
        t = _as_tensor(a, device)
        if t.numel() == 0:
            continue
        src, kind = _word_source(t)
        n = src.numel()
        for off in range(0, n, chunk):
            ln = min(chunk, n - off)
            plist = passes[kind]
            if not plist or plist[-1][0] + ln > chunk:
                plist.append([0, []])
            plist[-1][1].append((j, src, off, ln))
            plist[-1][0] += ln
    sums, leaf_ids = [], []
    for kind, plist in passes.items():
        for total, segs in plist:
            sums.append(_pass_sums(kind, total, segs, device))
            leaf_ids.extend(j for j, _s, _o, _n in segs)
    if not sums:
        return torch.zeros(2, dtype=torch.int64, device=device)
    ids = torch.tensor(leaf_ids, dtype=torch.int64, device=device)
    per_leaf = torch.zeros(len(arrs), dtype=torch.int64, device=device)
    per_leaf.index_add_(0, ids, torch.cat(sums) & _MASK32)
    per_leaf &= _MASK32
    salts = torch.tensor([_salts(j) for j in range(len(arrs))],
                         dtype=torch.int64, device=device)
    lo = _mulmod32(per_leaf, salts[:, 0]).sum() & _MASK32
    hi = _mulmod32(per_leaf, salts[:, 1]).sum() & _MASK32
    return torch.stack([lo, hi])


def _pass_sums(kind, total, segs, device):
    """One pass: each segment's ``sum((word * (2*i+1)) mod 2^32)``, ``i``
    the word's index within its leaf, as an int64 vector."""
    import torch

    if len(segs) == 1:
        _j, src, off, ln = segs[0]
        w = src[off:off + ln].to(torch.int64)
        odd = _odd(ln, device)
        if off:
            odd = odd + 2 * off
    else:
        w = torch.cat([src[off:off + ln] for _j, src, off, ln in segs]) \
            .to(torch.int64)
        shifts, pos = [], 0
        for _j, _src, off, ln in segs:
            shifts.append(off - pos)
            pos += ln
        shift = torch.repeat_interleave(
            torch.tensor(shifts, dtype=torch.int64, device=device),
            torch.tensor([ln for *_r, ln in segs], device=device))
        odd = _odd(total, device) + 2 * shift
    big = max(off + ln for _j, _s, off, ln in segs) > _BIG_INDEX
    if kind == "i16":
        w &= 0xFFFF
    elif big and kind == "i32":
        w &= _MASK32
    if big:
        base = _mulmod32(w, odd & _MASK32)
    else:
        # a sign-extended int32 word is w - 2^32 k: the same product mod
        # 2^32, and |w * odd| < 2^62 here
        base = w.mul_(odd).bitwise_and_(_MASK32)
    if len(segs) == 1:
        return base.sum().reshape(1)
    ends = torch.tensor([ln for *_r, ln in segs], device=device) \
        .cumsum(0) - 1
    cs = base.cumsum(0)[ends]
    return cs - torch.cat([cs.new_zeros(1), cs[:-1]])


def fingerprint_pytree(tree, chunk=None):
    """``fingerprint_arrays`` over the tree's leaves."""
    return fingerprint_arrays(_leaves(tree), chunk)


def trainer_leaves(trainer):
    """The tensors a ``gluon.Trainer``'s attestation fingerprints: the
    trained parameters in trainer order, then every optimizer state by
    trainer index (a multi-precision item's f32 master first, then its
    states), as ``_leaves`` flattens them."""
    upd = trainer._updaters[0]
    params = [p.data()._data for p in trainer._params
              if p.grad_req != "null"]

    def live(v):
        if isinstance(v, (list, tuple)):
            return [live(x) for x in v]
        return getattr(v, "_data", v)

    states = [live(upd.states[i]) for i in sorted(upd.states)]
    return _leaves([params, states])


def _host_words(a):
    import numpy as np

    a = np.ascontiguousarray(a)
    if a.dtype == np.bool_:
        return a.astype(np.uint32).ravel()
    size = a.dtype.itemsize
    if size == 4:
        return a.view(np.uint32).ravel()
    if size == 2:
        return a.view(np.uint16).ravel().astype(np.uint32)
    if size == 1:
        return a.view(np.uint8).ravel().astype(np.uint32)
    if size % 4 == 0:
        return a.view(np.uint32).ravel()
    return a.astype(np.float32).view(np.uint32).ravel()


def _host_array(a):
    """A leaf as a numpy array of its own words: a tensor read back (bf16
    as its 16-bit words), a numpy array or scalar as it is."""
    import numpy as np
    import torch

    a = getattr(a, "_data", a)
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(a)


def fingerprint_host(tree, chunk=None) -> int:
    """Numpy mirror of ``fingerprint_pytree``, combined into one u64:
    bitwise equal to ``combine(fingerprint_pytree(tree))`` and to the JAX
    package's ``fingerprint_host`` of the same leaves.  A large leaf runs
    in chunks of ``chunk`` (``CHUNK_WORDS``) words."""
    import numpy as np

    chunk = int(chunk or CHUNK_WORDS)
    odd = None
    lo = hi = 0
    for j, a in enumerate(_leaves(tree)):
        a = _host_array(a)
        if a.size == 0:
            continue
        words = _host_words(a)
        n = min(words.size, chunk)
        if odd is None or odd.size < n:
            odd = np.arange(n, dtype=np.uint64) * 2 + 1
        s = 0
        for off in range(0, words.size, chunk):
            w = words[off:off + chunk].astype(np.uint64)
            w *= odd[:w.size] if not off else odd[:w.size] + 2 * off
            w &= _MASK32
            s += int(w.sum(dtype=np.uint64))
        s &= _MASK32
        slo, shi = _salts(j)
        lo = (lo + s * slo) & _MASK32
        hi = (hi + s * shi) & _MASK32
    return (hi << 32) | lo


def combine(fp2) -> int:
    """Fold a ``(2,)`` ``[lo, hi]`` fingerprint (a tensor, or the JAX
    package's uint32 array) into one u64."""
    import numpy as np

    v = fp2.detach().cpu().tolist() if hasattr(fp2, "detach") \
        else np.asarray(fp2).tolist()
    return ((int(v[1]) & _MASK32) << 32) | (int(v[0]) & _MASK32)


def fp_hex(fp: int) -> str:
    return f"{int(fp):016x}"

# -- lineage ledger (tier 3) ---------------------------------------------------

_GENESIS = "0" * 64


class IntegrityLedger:
    """Hash-chained JSONL attestation ledger.

    Each line: ``{"step", "epoch", "rank", "fp", "prev", "hash", "t",
    "run"}`` where ``hash = sha256(prev + canonical-json(entry sans
    hash))``.  `head()` is the newest hash — `AsyncCheckpointer` stamps
    it into MANIFEST.json so `verify_provenance` can audit a restored
    checkpoint back to an attestation this process actually chained.
    Appends are serialized and fsync'd line-at-a-time (same durability
    discipline as the telemetry sink)."""

    def __init__(self, path):
        self.path = path
        self._lock = threading.Lock()
        self._head = None

    def head(self):
        """Newest chain hash, or None on an empty/absent ledger."""
        with self._lock:
            if self._head is None:
                entries = self.entries()
                self._head = entries[-1]["hash"] if entries else None
            return self._head

    def entries(self):
        """All parseable ledger lines, oldest first (torn tail lines
        are skipped, never fatal)."""
        if not self.path or not os.path.exists(self.path):
            return []
        out = []
        with open(self.path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and rec.get("hash"):
                    out.append(rec)
        return out

    @staticmethod
    def _entry_hash(prev, body):
        payload = json.dumps(body, sort_keys=True,
                             separators=(",", ":"))
        return hashlib.sha256(
            (prev + payload).encode("utf-8")).hexdigest()

    def append(self, step, fp, rank=0, epoch=0, run=None):
        """Chain one attestation; returns the entry (with its hash)."""
        if not self.path:
            return None
        with self._lock:
            prev = self._head
            if prev is None:
                entries = self.entries()
                prev = entries[-1]["hash"] if entries else _GENESIS
            body = {"step": int(step), "epoch": int(epoch),
                    "rank": int(rank), "fp": fp_hex(fp),
                    "prev": prev, "t": time.time()}
            if run is not None:
                body["run"] = run
            entry = dict(body, hash=self._entry_hash(prev, body))
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(json.dumps(entry, sort_keys=True,
                                   separators=(",", ":")) + "\n")
                f.flush()
                os.fsync(f.fileno())
            self._head = entry["hash"]
            return entry

    def verify_chain(self):
        """Recompute every hash link; returns (ok, reason)."""
        prev = _GENESIS
        for i, entry in enumerate(self.entries()):
            body = {k: v for k, v in entry.items() if k != "hash"}
            if body.get("prev") != prev:
                return False, f"entry {i}: prev {body.get('prev')!r} " \
                              f"does not chain onto {prev!r}"
            if self._entry_hash(prev, body) != entry["hash"]:
                return False, f"entry {i}: hash mismatch (ledger " \
                              f"tampered or torn mid-line)"
            prev = entry["hash"]
        return True, None

    def has_hash(self, h):
        if not h:
            return False
        return any(e.get("hash") == h for e in self.entries())


_LEDGER = None
_LEDGER_LOCK = threading.Lock()


def get_ledger():
    """Process-wide ledger for the current `ledger_path()` (None when
    no path resolves)."""
    global _LEDGER
    path = ledger_path()
    if path is None:
        return None
    with _LEDGER_LOCK:
        if _LEDGER is None or _LEDGER.path != path:
            _LEDGER = IntegrityLedger(path)
        return _LEDGER


def reset():
    """Drop the cached ledger handle (test isolation)."""
    global _LEDGER
    with _LEDGER_LOCK:
        _LEDGER = None


def ledger_head():
    """Current chain head for manifest stamping, or None."""
    led = get_ledger()
    return None if led is None else led.head()


def manifest_stamp():
    """The ``integrity`` block `checkpoint._write_manifest` embeds, or
    None when no ledger is configured / nothing attested yet."""
    led = get_ledger()
    if led is None:
        return None
    head = led.head()
    if head is None:
        return None
    return {"ledger_head": head, "ledger_path": led.path}


def verify_provenance(manifest):
    """Audit a manifest's integrity stamp against the local ledger.

    Returns (ok, reason).  Lenient where it must be — an unstamped
    manifest (pre-integrity writer) or an absent ledger (fresh machine,
    checkpoint shipped in) passes with a reason string — but a stamp
    that names a hash the ledger does NOT contain fails closed: the
    checkpoint claims a lineage this host has no record of."""
    stamp = manifest.get("integrity") if isinstance(manifest, dict) \
        else None
    if not isinstance(stamp, dict) or not stamp.get("ledger_head"):
        return True, "manifest carries no integrity stamp"
    led = get_ledger()
    if led is None or not os.path.exists(led.path or ""):
        return True, "no local ledger to audit against"
    ok, reason = led.verify_chain()
    if not ok:
        return False, f"ledger chain invalid: {reason}"
    if not led.has_hash(stamp["ledger_head"]):
        return False, (f"manifest ledger head "
                       f"{stamp['ledger_head'][:12]}... not present in "
                       f"{led.path}")
    return True, None


# -- tier 1 + 2: the plane -----------------------------------------------------

class IntegrityPlane:
    """Per-rank attestation plane.

    ``kv``: gang KV (FileKV/TcpKV — `distributed.gang_kv()` by
    default; None degrades to solo mode where only the ledger and the
    replay audit operate).  ``peers``: the ranks whose state must be
    bitwise-equal to ours (dp replicas; tp/fsdp shards pass their
    layout-mates).  Default: all of ``range(world)``."""

    def __init__(self, rank=0, world=1, kv=None, peers=None, every=None,
                 epoch=0, ledger=None, timeout=None, run=None):
        self.rank = int(rank)
        self.world = int(world)
        self.kv = kv
        self.peers = sorted(set(int(r) for r in peers)) \
            if peers is not None else list(range(self.world))
        if self.rank not in self.peers:
            self.peers = sorted(self.peers + [self.rank])
        self.every = attest_every() if every is None else max(1, int(every))
        self.epoch = int(epoch)
        self.timeout = peer_timeout() if timeout is None else float(timeout)
        self.ledger = get_ledger() if ledger is None else ledger
        self.run = run
        self.attestations = 0
        self.mismatches = 0
        self.replays = 0
        self.last_verdict = None
        self._retained = {}          # step -> (state, inputs)

    # -- schedule ---------------------------------------------------------------

    def due(self, step) -> bool:
        return step is not None and int(step) % self.every == 0

    # -- tier 2 retention -------------------------------------------------------

    def retain(self, step, state, inputs=None):
        """Retain the PRE-step state (host copies) + the step's inputs
        for shadow replay.  Bounded to the most recent retention — the
        audit only ever replays the last attested step."""
        self._retained = {int(step): (state, inputs)}

    def retained(self, step=None):
        if step is not None:
            return self._retained.get(int(step))
        if not self._retained:
            return None
        s = max(self._retained)
        return (s,) + self._retained[s]

    # -- tier 1 attestation -----------------------------------------------------

    def _key(self, epoch, step, rank):
        return f"integrity/{epoch}/{step}/{rank}"

    def publish(self, step, fp, epoch=None):
        epoch = self.epoch if epoch is None else int(epoch)
        if self.kv is not None:
            self.kv.put_json(self._key(epoch, step, self.rank), {
                "rank": self.rank, "step": int(step), "epoch": epoch,
                "fp": fp_hex(fp), "t": time.time()})
        if self.ledger is not None:
            self.ledger.append(step, fp, rank=self.rank, epoch=epoch,
                               run=self.run)

    def _gather(self, step, epoch):
        """Poll the KV until every peer published (or timeout):
        {rank: fp_hex}."""
        got = {}
        want = [r for r in self.peers]
        deadline = time.monotonic() + self.timeout
        while True:
            for r in want:
                if r in got:
                    continue
                try:
                    rec = self.kv.get_json(self._key(epoch, step, r))
                except Exception:
                    rec = None
                if isinstance(rec, dict) and rec.get("fp"):
                    got[r] = rec["fp"]
            if len(got) == len(want) or time.monotonic() >= deadline:
                return got
            time.sleep(0.005)

    def attest(self, step, fp, epoch=None):
        """One attestation round: publish, gather layout-mates, vote.

        Returns the verdict dict ``{step, epoch, fp, ok, corrupt,
        tie, votes, self_corrupt, absent}``.  Majority is truth; the
        minority rank(s) are corrupt.  A two-way tie (possible only
        with an even quorum) is reported ``ok=False, tie=True`` with
        no rank named — the replay audit is the tie-breaker.  Emits
        one ``integrity`` telemetry record per round; on a mismatch
        the lowest healthy voter additionally emits
        ``integrity_mismatch`` and one ``sdc_detected`` per corrupt
        rank (kind refined later by `audit`)."""
        step = int(step)
        epoch = self.epoch if epoch is None else int(epoch)
        self.attestations += 1
        self.publish(step, fp, epoch=epoch)
        mine = fp_hex(fp)
        votes = {self.rank: mine}
        if self.kv is not None and len(self.peers) > 1:
            votes.update(self._gather(step, epoch))
        tally = {}
        for r, v in votes.items():
            tally.setdefault(v, []).append(r)
        ranked = sorted(tally.items(),
                        key=lambda kv_: (-len(kv_[1]), min(kv_[1])))
        best_fp, best_ranks = ranked[0]
        tie = len(ranked) > 1 and len(ranked[1][1]) == len(best_ranks)
        ok = len(ranked) == 1
        corrupt = [] if ok or tie else sorted(
            r for v, rs in ranked[1:] for r in rs)
        absent = sorted(set(self.peers) - set(votes))
        verdict = {
            "step": step, "epoch": epoch, "fp": mine, "ok": ok,
            "tie": tie, "corrupt": corrupt, "votes": votes,
            "absent": absent, "self_corrupt": self.rank in corrupt,
        }
        self.last_verdict = verdict
        if not ok:
            self.mismatches += 1
        _tel_integrity(step=step, fp=mine, ok=ok, epoch=epoch,
                       peers=len(votes), corrupt=corrupt or None,
                       rank=self.rank)
        healthy = tally.get(best_fp, [])
        if not ok and not tie and healthy and \
                self.rank == min(healthy):
            # one announcer per verdict (the amendment discipline:
            # lowest healthy member speaks for the quorum)
            _tel_event("integrity_mismatch", step=step, epoch=epoch,
                       corrupt=corrupt, votes=len(votes))
            for r in corrupt:
                _tel_event("sdc_detected", rank=r, step=step,
                           kind="state_mismatch", epoch=epoch)
        return verdict

    # -- tier 2 audit -----------------------------------------------------------

    def audit(self, step_fn, live_fp, step=None, peers_agree=None):
        """Shadow replay: re-run the retained pre-step snapshot through
        ``step_fn(state, inputs) -> new_state`` and fingerprint the
        result (host math — `fingerprint_host`).

        Classification:
        - replay != live  → ``"memory"``: the live state was mutated
          outside the computation (bit flip / corrupt HBM);
        - replay == live, peers disagree → ``"compute"``: the step
          deterministically produces a wrong answer (bad core);
        - replay == live, peers agree (or solo) → ``"clean"``.

        Emits a ``replay_audit`` event, plus a kind-refined
        ``sdc_detected`` when corruption is confirmed.  Returns
        ``{kind, replay_fp, live_fp, step}`` or None when nothing is
        retained for the step."""
        if peers_agree is None:
            v = self.last_verdict
            peers_agree = v is None or v["ok"] or \
                self.rank not in v.get("corrupt", ())
        if step is None:
            ret = self.retained()
            if ret is None:
                return None
            step, state, inputs = ret
        else:
            ret = self.retained(step)
            if ret is None:
                return None
            state, inputs = ret
        self.replays += 1
        new_state = step_fn(state, inputs) if inputs is not None \
            else step_fn(state)
        replay_fp = fingerprint_host(new_state)
        live = int(live_fp)
        if replay_fp != live:
            kind = "memory"
        elif not peers_agree:
            kind = "compute"
        else:
            kind = "clean"
        out = {"kind": kind, "replay_fp": fp_hex(replay_fp),
               "live_fp": fp_hex(live), "step": int(step)}
        _tel_event("replay_audit", rank=self.rank, step=int(step),
                   kind=kind, replay_fp=out["replay_fp"],
                   live_fp=out["live_fp"])
        if kind != "clean":
            _tel_event("sdc_detected", rank=self.rank, step=int(step),
                       kind=kind, epoch=self.epoch)
        return out

    # -- quarantine -------------------------------------------------------------

    def quarantine(self, gang, verdict=None):
        """Turn a mismatch verdict into the `resilience.RankFailure`
        the existing elastic recovery path consumes: the survivors call
        ``gang.recover(failure)``, which reshapes the mesh around the
        corrupt rank(s) and restores state from a buddy snapshot or the
        disk manifest; the quarantined rank sees the epoch move past it
        (GangEvicted) and `ElasticGang.join`s back with clean state.
        Returns None when the verdict names nobody (ok or tie)."""
        from . import resilience

        verdict = self.last_verdict if verdict is None else verdict
        if not verdict or not verdict.get("corrupt"):
            return None
        corrupt = sorted(verdict["corrupt"])
        for r in corrupt:
            _tel_event("rank_quarantined", rank=r,
                       step=verdict.get("step"), epoch=gang.epoch)
        return resilience.RankFailure(corrupt, gang.epoch)


# -- fault-injection hooks -----------------------------------------------------

def _flip_bit(t, bit=20):
    """Flip bit ``min(bit, width-1)`` of element 0 of a tensor in place
    (``bit_flip_host``'s rule: bit 20 of a 32-bit word, the top bit of a
    16-bit one)."""
    import torch

    flat = t.detach().view(-1)[:1]
    size = flat.element_size()
    view = flat.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                      1: torch.uint8}[size])
    mask = 1 << min(bit, size * 8 - 1)
    if size > 1 and mask >= 1 << (size * 8 - 1):
        mask -= 1 << (size * 8)       # the signed view's top bit
    view.bitwise_xor_(mask)
    return t


def bit_flip_host(arr, bit=20):
    """In-place single-bit flip of element 0 of a numpy array."""
    import numpy as np

    a = np.ascontiguousarray(arr)
    size = a.dtype.itemsize
    view = a.view({8: np.uint64, 4: np.uint32,
                   2: np.uint16}.get(size, np.uint8)).ravel()
    view[0] ^= type(view[0])(1 << min(bit, size * 8 - 1))
    if a is not arr:
        arr.ravel()[0] = a.ravel()[0]
    return arr


def _float_tensor(x):
    """The dense float tensor behind a Parameter, an NDArray or a tensor,
    or None."""
    import torch

    if not isinstance(x, torch.Tensor) and callable(getattr(x, "data", None)):
        x = x.data()
    if getattr(x, "stype", "default") != "default":
        return None
    x = getattr(x, "_data", x)
    if isinstance(x, torch.Tensor) and x.is_floating_point() \
            and x.numel() > 0:
        return x
    return None


def maybe_bit_flip_param(rank=None, params=()) -> bool:
    """``bit_flip_param:K``: flip one bit in the first float parameter of
    rank K, once, in place: the live state diverges from its replicas
    and from its own replay (``kind="memory"``).  Returns True when it
    fired."""
    import numpy as np

    from . import resilience

    if rank is None:
        rank = self_rank()
    if not resilience.consume_rank_fault("bit_flip_param", rank):
        return False
    for p in params:
        t = _float_tensor(p)
        if t is not None:
            _flip_bit(t)
            return True
        if isinstance(p, np.ndarray) and p.dtype.kind == "f" and p.size:
            bit_flip_host(p)
            return True
    return False


def maybe_bit_flip_grad(rank=None, grads=()) -> bool:
    """``bit_flip_grad:K``: flip one bit in rank K's first float gradient
    before the update (the eager path: the captured step's gradients
    never reach a buffer, so the Trainer routes the armed step to the
    eager oracle, as for ``nan_grad``)."""
    from . import resilience

    if rank is None:
        rank = self_rank()
    if not grads or not resilience.consume_rank_fault("bit_flip_grad",
                                                      rank):
        return False
    for g in grads:
        t = _float_tensor(g)
        if t is not None:
            _flip_bit(t)
            return True
    return False


def maybe_bad_core(rank=None, value=None):
    """``bad_core:K``: rank K's compute is deterministically wrong:
    returns a perturbed copy of ``value`` (the step's input) once the
    charge fires, else ``value`` unchanged.  Perturbing the input before
    it is recorded for replay makes the shadow replay reproduce the
    wrong answer (``kind="compute"``)."""
    from . import resilience

    if rank is None:
        rank = self_rank()
    if not resilience.consume_rank_fault("bad_core", rank):
        return value
    import numpy as np

    out = np.array(value, copy=True)
    flat = out.ravel()
    if flat.size and out.dtype.kind == "f":
        flat[0] = flat[0] * 1.0000001 + 1e-6
    return out if isinstance(value, np.ndarray) else type(value)(out)
