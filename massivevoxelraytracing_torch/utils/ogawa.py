"""Ogawa container reader/writer (the port's copy of the JAX package's
utils/ogawa.py).

Ogawa is Alembic's mmap-friendly binary container (the transport layer under
every modern `.abc` file; the reference ingests these via prlib/Alembic,
voxUtil.hpp:8-35, RTCamp.cpp:95-109). The container itself is tiny and
fully specified:

  header (16 B):  "Ogawa" | frozen u8 (0xff complete, 0x00 mid-write)
                  | version u16 LE (1) | root group offset u64 LE
  group at p:     u64 child count N, then N u64 child words; a child word
                  with bit 63 SET addresses a DATA blob (offset = low 63
                  bits), CLEAR addresses a sub-GROUP. 0 = empty group,
                  0x8000...0 = empty data.
  data at p:      u64 byte size, then the bytes.

The Alembic semantic layer on top lives in abcio.py."""

from __future__ import annotations

import mmap
import struct

MAGIC = b"Ogawa"
DATA_BIT = 1 << 63
MASK = DATA_BIT - 1

EMPTY_GROUP = 0
EMPTY_DATA = DATA_BIT


class OgawaReader:
    """Zero-copy reader over an mmap'd Ogawa file."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self.buf = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        if self.buf[:5] != MAGIC:
            raise ValueError(f"{path}: not an Ogawa file")
        frozen = self.buf[5]
        if frozen != 0xFF:
            raise ValueError(f"{path}: archive not frozen (partial write?)")
        (self.version,) = struct.unpack_from("<H", self.buf, 6)
        (self.root,) = struct.unpack_from("<Q", self.buf, 8)

    def close(self):
        self.buf.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def group(self, word: int) -> list:
        """Child words of the group addressed by `word` (must be a group)."""
        assert not (word & DATA_BIT), "data word passed to group()"
        if word == EMPTY_GROUP:
            return []
        p = word
        (n,) = struct.unpack_from("<Q", self.buf, p)
        return list(struct.unpack_from(f"<{n}Q", self.buf, p + 8))

    def data(self, word: int) -> memoryview:
        """Payload of the data blob addressed by `word` (must be data)."""
        assert word & DATA_BIT, "group word passed to data()"
        p = word & MASK
        if p == 0:
            return memoryview(b"")
        (size,) = struct.unpack_from("<Q", self.buf, p)
        return memoryview(self.buf)[p + 8:p + 8 + size]

    @staticmethod
    def is_data(word: int) -> bool:
        return bool(word & DATA_BIT)


class OgawaWriter:
    """Builds an Ogawa file from nested python structures:
    group = list of (group-lists or bytes); bytes/bytearray/memoryview
    children become data blobs."""

    def write(self, path: str, root: list):
        chunks = [bytearray(16)]  # header patched at the end
        offset = [16]

        def emit(b: bytes) -> int:
            p = offset[0]
            chunks.append(b)
            offset[0] += len(b)
            return p

        def write_node(node) -> int:
            if isinstance(node, (bytes, bytearray, memoryview)):
                b = bytes(node)
                if not b:
                    return EMPTY_DATA
                return DATA_BIT | emit(struct.pack("<Q", len(b)) + b)
            assert isinstance(node, list)
            words = [write_node(c) for c in node]
            if not words:
                return EMPTY_GROUP
            return emit(struct.pack(f"<Q{len(words)}Q", len(words), *words))

        root_word = write_node(root)
        header = bytearray(16)
        header[:5] = MAGIC
        header[5] = 0xFF
        struct.pack_into("<H", header, 6, 1)
        struct.pack_into("<Q", header, 8, root_word)
        chunks[0] = header
        with open(path, "wb") as f:
            for c in chunks:
                f.write(c)
