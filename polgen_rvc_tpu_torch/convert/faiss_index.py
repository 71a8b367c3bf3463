"""faiss .index binary reader and writer with no faiss dependency: a copy
of the JAX package's convert/faiss_index.py.

RVC ships IVF-Flat indexes ("IVF<n>,Flat" over float32 vectors, L2 metric)
built by its training tool. The reader parses the serialized format and
returns the dense (N, d) vectors in id order (faiss reconstruct_n), which
the retrieval layer searches exactly.

Format (faiss 1.7.x impl/index_read.cpp, index_write.cpp):
  index header: fourcc | d:i32 | ntotal:i64 | dummy:i64 x2 | is_trained:u8 |
                metric:i32 [| metric_arg:f32 if metric>1]
  IndexFlat ("IxF2"/"IxFI"/"IxFl"): header + codes byte-vector (u64 len + raw)
  IndexIVFFlat ("IwFl"): header + nlist:u64 + nprobe:u64 + quantizer index +
                direct-map (type:u8 + u64-len vector) + inverted lists
  ArrayInvertedLists ("ilar"): nlist:u64 | code_size:u64 | "full"+sizes or
                "sprs"+pairs | per-list codes then ids (i64)
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np


def _fourcc(s: bytes) -> int:
    return struct.unpack("<I", s)[0]

FOURCC_IXF2 = _fourcc(b"IxF2")  # IndexFlat L2
FOURCC_IXFI = _fourcc(b"IxFI")  # IndexFlat inner product
FOURCC_IXFL = _fourcc(b"IxFl")  # IndexFlat other metric
FOURCC_IWFL = _fourcc(b"IwFl")  # IndexIVFFlat
FOURCC_ILAR = _fourcc(b"ilar")  # ArrayInvertedLists
FOURCC_FULL = _fourcc(b"full")
FOURCC_SPRS = _fourcc(b"sprs")

METRIC_INNER_PRODUCT = 0
METRIC_L2 = 1


@dataclasses.dataclass
class FaissIndex:
    d: int
    ntotal: int
    metric: int
    vectors: np.ndarray  # (ntotal, d) float32, ordered by id
    nlist: int = 0
    centroids: np.ndarray | None = None  # (nlist, d) for IVF indexes


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from("<" + fmt, self.data, self.pos)
        self.pos += size
        return vals if len(vals) > 1 else vals[0]

    def read_raw(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def read_vector(self, dtype) -> np.ndarray:
        n = self.read("Q")
        raw = self.read_raw(n * np.dtype(dtype).itemsize)
        return np.frombuffer(raw, dtype=dtype).copy()


def _read_index_header(r: _Reader):
    d = r.read("i")
    ntotal = r.read("q")
    r.read("qq")  # dummies
    is_trained = r.read("B")
    metric = r.read("i")
    if metric > 1:
        r.read("f")  # metric_arg
    return d, ntotal, bool(is_trained), metric


def _read_flat(r: _Reader, metric_hint: int):
    d, ntotal, _, metric = _read_index_header(r)
    codes = r.read_vector(np.uint8)
    vecs = codes.view(np.float32).reshape(ntotal, d)
    return FaissIndex(d=d, ntotal=ntotal, metric=metric, vectors=vecs)


def _read_inverted_lists(r: _Reader):
    h = r.read("I")
    if h != FOURCC_ILAR:
        raise ValueError(f"unsupported inverted-list type fourcc={h:#x}")
    nlist = r.read("Q")
    code_size = r.read("Q")
    list_type = r.read("I")
    sizes = np.zeros(nlist, np.int64)
    if list_type == FOURCC_FULL:
        sizes = r.read_vector(np.uint64).astype(np.int64)
    elif list_type == FOURCC_SPRS:
        pairs = r.read_vector(np.uint64).astype(np.int64)
        for i in range(0, len(pairs), 2):
            sizes[pairs[i]] = pairs[i + 1]
    else:
        raise ValueError(f"unknown list size encoding {list_type:#x}")
    codes, ids = [], []
    for i in range(nlist):
        n = int(sizes[i])
        if n > 0:
            codes.append(np.frombuffer(r.read_raw(n * code_size), np.uint8).copy())
            ids.append(np.frombuffer(r.read_raw(n * 8), np.int64).copy())
        else:
            codes.append(np.empty(0, np.uint8))
            ids.append(np.empty(0, np.int64))
    return code_size, codes, ids


def _read_ivf_flat(r: _Reader):
    d, ntotal, _, metric = _read_index_header(r)
    nlist = r.read("Q")
    r.read("Q")  # nprobe
    quantizer = _read_any(r)
    # direct map: type byte + array vector (faiss >= 1.6.1)
    r.read("B")
    r.read_vector(np.uint64)
    code_size, codes, ids = _read_inverted_lists(r)
    if code_size != d * 4:
        raise ValueError(f"IVFFlat code_size {code_size} != 4*d ({d})")
    vectors = np.zeros((ntotal, d), np.float32)
    for c, i in zip(codes, ids):
        if len(i):
            vectors[i] = c.view(np.float32).reshape(len(i), d)
    return FaissIndex(
        d=d, ntotal=ntotal, metric=metric, vectors=vectors,
        nlist=int(nlist), centroids=quantizer.vectors,
    )


def _read_any(r: _Reader) -> FaissIndex:
    h = r.read("I")
    if h in (FOURCC_IXF2, FOURCC_IXFI, FOURCC_IXFL):
        return _read_flat(r, h)
    if h == FOURCC_IWFL:
        return _read_ivf_flat(r)
    raise ValueError(
        f"unsupported faiss index type fourcc={struct.pack('<I', h)!r}; "
        "supported: IndexFlat(L2/IP), IndexIVFFlat"
    )


def read_faiss_index(path: str) -> FaissIndex:
    """Parse a .index file -> dense vector bank (reconstruct_n equivalent)."""
    with open(path, "rb") as f:
        data = f.read()
    return _read_any(_Reader(data))


# ---------------------------------------------------------------------------
# writer (synthetic indexes and round-trip tests)
# ---------------------------------------------------------------------------


def _write_index_header(out, d, ntotal, metric):
    out += struct.pack("<i", d)
    out += struct.pack("<q", ntotal)
    out += struct.pack("<qq", 1 << 20, 1 << 20)
    out += struct.pack("<B", 1)
    out += struct.pack("<i", metric)
    return out


def write_ivf_flat(
    path: str, vectors: np.ndarray, centroids: np.ndarray, assignments: np.ndarray,
    metric: int = METRIC_L2,
):
    """Serialize an IVF-Flat index faiss can read back (and our reader too)."""
    vectors = np.ascontiguousarray(vectors, np.float32)
    centroids = np.ascontiguousarray(centroids, np.float32)
    ntotal, d = vectors.shape
    nlist = centroids.shape[0]

    out = bytearray()
    out += struct.pack("<I", FOURCC_IWFL)
    out = _write_index_header(out, d, ntotal, metric)
    out += struct.pack("<QQ", nlist, 1)  # nlist, nprobe
    # quantizer: IndexFlat over centroids
    out += struct.pack("<I", FOURCC_IXF2 if metric == METRIC_L2 else FOURCC_IXFI)
    out = _write_index_header(out, d, nlist, metric)
    cbytes = centroids.tobytes()
    out += struct.pack("<Q", len(cbytes)) + cbytes
    # direct map: NoMap
    out += struct.pack("<B", 0)
    out += struct.pack("<Q", 0)
    # inverted lists
    out += struct.pack("<I", FOURCC_ILAR)
    out += struct.pack("<QQ", nlist, d * 4)
    out += struct.pack("<I", FOURCC_FULL)
    lists = [np.where(assignments == i)[0].astype(np.int64) for i in range(nlist)]
    sizes = np.array([len(l) for l in lists], np.uint64)
    out += struct.pack("<Q", nlist) + sizes.tobytes()
    for ids in lists:
        if len(ids):
            out += vectors[ids].tobytes()
            out += ids.tobytes()
    with open(path, "wb") as f:
        f.write(bytes(out))
