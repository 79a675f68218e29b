"""RecordIO: the reference's packed-record container format.

Counterpart of ``mxnet_tpu/recordio.py`` (reference: dmlc-core's RecordIO
codec, include/dmlc/recordio.h, and python/mxnet/recordio.py):
MXRecordIO, MXIndexedRecordIO, IRHeader, pack/unpack, pack_img/unpack_img.

Byte-compatible with the reference format and with the JAX package: each
record is ``[kMagic:u32][cflag|length:u32][payload][pad to 4]`` with
kMagic 0xced7230a; cflag (upper 3 bits) marks continuation splits when a
record contains the magic.  A file either package writes, the other
reads.  The corrupt-record policies are the JAX package's: strict
(raise), or ``skip_corrupt=True`` (skip a poisoned record, read a
truncated tail as EOF, resync past a bad magic), each with a warning.

A C++ fast path (src/recordio.cc, loaded by ``_native``) serves bulk
reads; this module is the reference implementation and fallback.  Host
code only: nothing here touches a device.
"""

from __future__ import annotations

import ctypes
import numbers
import os
import struct

import numpy as np

from . import resilience
from .base import MXNetError

_MAGIC = 0xced7230a
_LFLAG_BITS = 29
_LENGTH_MASK = (1 << _LFLAG_BITS) - 1


def _encode_lrec(cflag, length):
    return (cflag << _LFLAG_BITS) | length


def _decode_lrec(data):
    return data >> _LFLAG_BITS, data & _LENGTH_MASK


class MXRecordIO:
    """Sequential .rec reader/writer (reference: mx.recordio.MXRecordIO).

    ``skip_corrupt=True`` makes the reader tolerate corruption: a bad
    magic resyncs to the next aligned magic, a truncated tail reads as
    EOF, and an injected-corrupt record is skipped — each with a warning.
    The default is strict (raise MXNetError), matching the reference.
    """

    def __init__(self, uri, flag, skip_corrupt=False):
        self.uri = uri
        self.flag = flag
        self.skip_corrupt = skip_corrupt
        self.handle = None
        self.is_open = False
        self.open()

    def open(self, _reopen=False):
        if self.flag == "w":
            # a re-open (unpickle / fork reset) must NOT truncate what was
            # already written — append instead
            self.handle = resilience.io_retry(
                lambda: open(self.uri, "ab" if _reopen else "wb"),
                description=f"open {self.uri}")
            self.writable = True
        elif self.flag == "r":
            self.handle = resilience.io_retry(
                lambda: open(self.uri, "rb"),
                description=f"open {self.uri}")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.pid = os.getpid()
        self.is_open = True
        self._nread = 0

    def close(self):
        if not self.is_open:
            return
        self.handle.close()
        self.is_open = False
        self.pid = None

    def __del__(self):
        self.close()

    def __getstate__(self):
        """Override pickling behavior (DataLoader worker support)."""
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        d.pop("handle", None)
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        is_open = d.get("is_open", False)
        self.is_open = False
        self.handle = None
        if is_open:
            self.open(_reopen=True)

    def _check_pid(self, allow_reset=False):
        # forked workers must reopen to get their own file offset
        if self.pid != os.getpid():
            if allow_reset:
                self.reset()
            else:
                raise RuntimeError("Forbidden operation in multiple "
                                   "processes")

    def write(self, buf):
        """Write one record with reference framing (continuation-split on
        embedded magics).

        dmlc-core semantics (3rdparty/dmlc-core/src/recordio.cc
        RecordIOWriter::WriteRecord): scan only 4-byte-ALIGNED positions
        for the magic; each embedded aligned magic is EXCISED from the
        written payload and acts as the chunk delimiter (cflag 1=first,
        2=middle, 3=last chunk); the reader re-inserts kMagic before every
        cflag-2/3 chunk.  Unaligned embedded magics are left in place
        (harmless — framing is aligned).
        """
        assert self.writable
        self._check_pid()
        magic_bytes = struct.pack("<I", _MAGIC)
        splits = []
        idx = buf.find(magic_bytes)
        while idx != -1:
            if idx % 4 == 0:
                splits.append(idx)
                idx = buf.find(magic_bytes, idx + 4)
            else:
                idx = buf.find(magic_bytes, idx + 1)
        if not splits:
            self._write_chunk(0, buf)
            return
        begin = 0
        for n, i in enumerate(splits):
            self._write_chunk(1 if n == 0 else 2, buf[begin:i])
            begin = i + 4
        self._write_chunk(3, buf[begin:])

    def _write_chunk(self, cflag, data):
        # each chunk stores its OWN payload length (dmlc framing)
        self.handle.write(struct.pack("<II", _MAGIC,
                                      _encode_lrec(cflag, len(data))))
        self.handle.write(data)
        pad = (4 - len(data) % 4) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def _corrupt(self, msg):
        """Corruption policy gate: strict raises; skip_corrupt warns and
        returns True so the caller can skip/resync."""
        if not self.skip_corrupt:
            raise MXNetError(msg)
        import warnings

        warnings.warn(f"RecordIO: {msg}; skipping (skip_corrupt=True)",
                      stacklevel=3)
        return True

    def _resync(self, magic_bytes):
        """Scan forward to the next 4-byte-ALIGNED magic (framing is
        aligned, so any real record header lands there); returns False at
        EOF.  Only reachable in skip_corrupt mode."""
        pos = self.handle.tell() - 4  # re-examine the 2nd header word
        pos += (-pos) % 4
        self.handle.seek(pos)
        while True:
            chunk_start = self.handle.tell()
            chunk = self.handle.read(1 << 16)
            if not chunk:
                return False
            i = chunk.find(magic_bytes)
            while i != -1:
                if (chunk_start + i) % 4 == 0:
                    self.handle.seek(chunk_start + i)
                    return True
                i = chunk.find(magic_bytes, i + 1)
            # a magic may straddle the chunk boundary
            self.handle.seek(chunk_start + max(1, len(chunk) - 3))

    def read(self):
        """Read one record; None at EOF.

        Re-inserts the excised kMagic before every continuation (cflag
        2/3) chunk — dmlc-core RecordIOReader::NextRecord semantics.

        Corruption detection: a bad magic, a partial trailing header, or
        a short payload read (truncated tail) hits the ``skip_corrupt``
        policy — strict raise by default, warn+skip/resync when enabled.
        The ``corrupt_record:K`` fault-injection site makes the K-th
        record of this reader read as corrupt (hermetic test hook).
        """
        assert not self.writable
        self._check_pid(allow_reset=True)
        out = None
        magic_bytes = struct.pack("<I", _MAGIC)
        while True:
            header = self.handle.read(8)
            if len(header) < 8:
                if len(header) == 0 and out is None:
                    return None  # clean EOF
                self._corrupt(
                    f"truncated RecordIO tail in {self.uri} "
                    f"({len(header)} trailing header bytes)")
                return None
            magic, lrec = struct.unpack("<II", header)
            if magic != _MAGIC:
                self._corrupt(
                    f"Invalid RecordIO magic in {self.uri} at offset "
                    f"{self.handle.tell() - 8}")
                out = None
                if self._resync(magic_bytes):
                    continue
                return None
            cflag, length = _decode_lrec(lrec)
            data = self.handle.read(length)
            if len(data) < length:
                self._corrupt(
                    f"truncated RecordIO record in {self.uri} (want "
                    f"{length} payload bytes, got {len(data)})")
                return None
            self._skip_pad(length)
            complete = None
            if cflag == 0:
                complete = data
            elif cflag == 1:
                out = data
                continue
            elif out is None:
                self._corrupt(
                    f"RecordIO continuation chunk without start in "
                    f"{self.uri}")
                continue  # skip mode: drop the orphan chunk, keep going
            else:
                out += magic_bytes + data
                if cflag != 3:
                    continue
                complete = out
                out = None
            idx = self._nread
            self._nread += 1
            if resilience.fault_arg("corrupt_record") == idx and \
                    resilience.consume_fault("corrupt_record"):
                self._corrupt(
                    f"injected corrupt record {idx} in {self.uri}")
                continue  # skip mode: drop the poisoned record
            return complete

    def _skip_pad(self, length):
        pad = (4 - length % 4) % 4
        if pad:
            self.handle.read(pad)

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.handle.tell()

    def seek(self, pos):
        assert not self.writable
        self._check_pid(allow_reset=True)
        self.handle.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access .rec with .idx sidecar (reference:
    mx.recordio.MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int,
                 skip_corrupt=False):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag, skip_corrupt=skip_corrupt)

    def open(self, _reopen=False):
        super().open(_reopen=_reopen)
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.isfile(self.idx_path):
            self.fidx = resilience.io_retry(
                lambda: open(self.idx_path, "r"),
                description=f"open {self.idx_path}")
            for line in iter(self.fidx.readline, ""):
                line = line.strip().split("\t")
                key = self.key_type(line[0])
                self.idx[key] = int(line[1])
                self.keys.append(key)
        elif self.flag == "w":
            self.fidx = open(self.idx_path, "a" if _reopen else "w")

    def close(self):
        if not self.is_open:
            return
        super().close()
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None

    def __getstate__(self):
        d = super().__getstate__()
        d.pop("fidx", None)
        return d

    def seek(self, idx):
        assert not self.writable
        self._check_pid(allow_reset=True)
        pos = self.idx[idx]
        self.handle.seek(pos)

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)


# -- image record header (reference: python/mxnet/recordio.py IRHeader) --------

_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class IRHeader:
    """flag, label, id, id2 (reference: IRHeader namedtuple)."""

    __slots__ = ("flag", "label", "id", "id2")

    def __init__(self, flag, label, id, id2):
        self.flag = flag
        self.label = label
        self.id = id
        self.id2 = id2

    def __iter__(self):
        return iter((self.flag, self.label, self.id, self.id2))

    def __eq__(self, other):
        return tuple(self) == tuple(other)


def pack(header, s):
    """Pack a header and byte payload into one record (reference: pack)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = IRHeader(0, header.label, header.id, header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = IRHeader(label.size, 0, header.id, header.id2)
        s = label.tobytes() + s
    s = struct.pack(_IR_FORMAT, int(header.flag), float(header.label),
                    int(header.id), int(header.id2)) + s
    return s


def unpack(s):
    """Unpack a record into (IRHeader, payload)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = IRHeader(header.flag, label, header.id, header.id2)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image array (H,W,C uint8) via PIL encode (the reference
    uses OpenCV)."""
    from .image import imencode

    return pack(header, imencode(img, quality=quality, img_fmt=img_fmt))


def unpack_img(s, iscolor=-1):
    """Unpack a record into (IRHeader, image ndarray)."""
    from .image import imdecode_np

    header, s = unpack(s)
    return header, imdecode_np(s, iscolor)
