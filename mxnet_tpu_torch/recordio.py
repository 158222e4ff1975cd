"""RecordIO container and packed-image records (counterpart of
``mxnet_tpu/recordio.py``; ref: python/mxnet/recordio.py ::
MXRecordIO, MXIndexedRecordIO, IRHeader, pack/unpack,
pack_img/unpack_img, over dmlc-core's recordio framing).

Files are byte-identical with the reference's, both ways:
  record  = [kMagic u32][lrec u32][data][pad to 4B]
  lrec    = (cflag << 29) | length
  cflag   = 0 whole, 1 first, 2 middle, 3 last: a payload that holds the
            magic word at a 4-byte-aligned offset is split there and the
            magic is put back on read (dmlc recordio semantics)
  IRHeader= struct IfQQ (flag, label, id, id2); flag > 0 means `flag`
            float32 labels follow the header.

A reader is safe in forked processes, as MXNet 1.x's is: it remembers
the pid that opened it, and a reader used in another process reopens its
file first, so forked DataLoader workers do not share one file offset
(the reference shares it; ROADMAP queue 3). A writer used in another
process raises. The training path reads these files through the native
pipeline (``csrc/io.cc``, :class:`io.ImageRecordIter`); this module is
the API surface and the writer.
"""
from __future__ import annotations

import numbers
import os
import struct
from collections import namedtuple

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_MAGIC_BYTES = struct.pack("<I", _MAGIC)
_LREC_MASK = (1 << 29) - 1


class MXRecordIO:
    """Sequential .rec reader/writer (ref: recordio.py :: MXRecordIO)."""

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self.record = None
        self.is_open = False
        self.pid = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("invalid flag %r" % self.flag)
        self.pid = os.getpid()
        self.is_open = True

    def close(self):
        if self.is_open:
            self.record.close()
            self.is_open = False
            self.pid = None

    def reset(self):
        self.close()
        self.open()

    def _check_pid(self, allow_reset=False):
        """Reopen a reader used in a process other than the one that
        opened it (a forked worker inherits the parent's file offset);
        refuse a writer (MXNet 1.x's ``_check_pid``)."""
        if self.pid == os.getpid():
            return
        if not allow_reset:
            raise MXNetError("%s: a RecordIO writer cannot be used in a "
                             "process other than the one that opened it"
                             % self.uri)
        self.reset()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        if self.is_open and not self.writable:
            d["_pos"] = self.record.tell()
        d["record"] = None
        d["is_open"] = False
        d["pid"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        if d.get("uri"):
            self.open()
            if self.flag == "r":
                self.record.seek(d.get("_pos", 0))

    # ------------------------------------------------------------------
    def tell(self) -> int:
        return self.record.tell()

    def write(self, buf: bytes):
        assert self.writable
        self._check_pid(allow_reset=False)
        # dmlc framing: split the payload at 4-byte-ALIGNED magic
        # occurrences (recordio.cc :: FindMagic steps by 4)
        chunks = []
        start = 0
        p = 0
        while p + 4 <= len(buf):
            if buf[p:p + 4] == _MAGIC_BYTES:
                chunks.append(buf[start:p])
                start = p + 4
            p += 4
        chunks.append(buf[start:])
        n = len(chunks)
        for i, chunk in enumerate(chunks):
            if n == 1:
                cflag = 0
            elif i == 0:
                cflag = 1
            elif i == n - 1:
                cflag = 3
            else:
                cflag = 2
            lrec = (cflag << 29) | len(chunk)
            self.record.write(_MAGIC_BYTES)
            self.record.write(struct.pack("<I", lrec))
            self.record.write(chunk)
            pad = (4 - len(chunk) % 4) % 4
            if pad:
                self.record.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        self._check_pid(allow_reset=True)
        parts = []
        while True:
            head = self.record.read(8)
            if len(head) < 8:
                if parts:
                    raise IOError("truncated multi-part record")
                return None
            magic, lrec = struct.unpack("<II", head)
            if magic != _MAGIC:
                raise IOError("invalid RecordIO magic 0x%08x" % magic)
            cflag = lrec >> 29
            length = lrec & _LREC_MASK
            data = self.record.read(length)
            if len(data) < length:
                raise IOError("truncated record")
            pad = (4 - length % 4) % 4
            if pad:
                self.record.read(pad)
            if cflag == 0:
                if parts:
                    raise IOError("unexpected whole record inside multi-part")
                return data
            parts.append(data)
            if cflag == 3:
                return _MAGIC_BYTES.join(parts)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access .rec via a text .idx of `key\\tposition` lines
    (ref: recordio.py :: MXIndexedRecordIO)."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.exists(self.idx_path):
            with open(self.idx_path) as f:
                for line in f:
                    line = line.strip().split("\t")
                    if len(line) < 2:
                        continue
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)
            self.fidx = None
        elif self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def seek(self, idx):
        assert not self.writable
        self._check_pid(allow_reset=True)
        self.record.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf: bytes):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


# ----------------------------------------------------------------------
IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s: bytes) -> bytes:
    """Pack an IRHeader (and a float label vector, if the label is one)
    with its payload (ref: recordio.py :: pack)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, *header) + s


def unpack(s: bytes):
    """Inverse of pack: returns (IRHeader, payload)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg") -> bytes:
    """Encode an image array (BGR, as OpenCV reads it) and pack it (ref:
    recordio.py :: pack_img; OpenCV, as the reference)."""
    import cv2
    encode_params = None
    if img_fmt.lower() in (".jpg", ".jpeg"):
        encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif img_fmt.lower() == ".png":
        encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
    ret, buf = cv2.imencode(img_fmt, img, encode_params)
    if not ret:
        raise MXNetError("failed to encode image as %s" % img_fmt)
    return pack(header, buf.tobytes())


def unpack_img(s, iscolor=-1):
    """Unpack a packed image record to (IRHeader, BGR ndarray)."""
    import cv2
    header, img_bytes = unpack(s)
    img = cv2.imdecode(np.frombuffer(img_bytes, dtype=np.uint8), iscolor)
    return header, img
