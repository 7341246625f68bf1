"""CRC-32C (Castagnoli) — pure-Python/NumPy oracle implementation.

Polynomial 0x1EDC6F41 (reflected form 0x82F63B78).  This is the checksum
the framed format applies (masked) to every chunk's uncompressed payload
(SURVEY.md §8.2).  Production paths use the C++ native extension
(hardware CRC32C instruction) or the device GF(2)-matmul kernel; this module
is the correctness oracle for both.
"""

from __future__ import annotations

import numpy as np

CRC32C_POLY_REFLECTED = 0x82F63B78


def _make_table() -> np.ndarray:
    table = np.empty(256, dtype=np.uint32)
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ (CRC32C_POLY_REFLECTED if (c & 1) else 0)
        table[n] = c
    return table


_TABLE = _make_table()

# Slice-by-8 tables for the vectorized numpy path.
def _make_slice8() -> np.ndarray:
    t = np.empty((8, 256), dtype=np.uint32)
    t[0] = _TABLE
    for k in range(1, 8):
        t[k] = t[0][t[k - 1] & 0xFF] ^ (t[k - 1] >> 8)
    return t


_SLICE8 = _make_slice8()


def crc32c(data: bytes | bytearray | memoryview | np.ndarray, crc: int = 0) -> int:
    """CRC-32C of data, with optional running crc (unfinalized semantics:
    crc32c(b) == crc32c(b2, crc32c(b1)) for b == b1 + b2)."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data.astype(np.uint8, copy=False)
    c = np.uint32(crc ^ 0xFFFFFFFF)
    n = len(buf)
    # Process 8 bytes at a time with slice-by-8, vectorized over the table
    # lookups per lane (still a Python loop over 8 lanes per word — fine
    # for an oracle; the fast paths live in native/ and kernels/).
    i = 0
    t = _SLICE8
    with np.errstate(over="ignore"):
        while n - i >= 8:
            chunk = buf[i : i + 8].astype(np.uint32)
            c0 = c ^ (chunk[0] | (chunk[1] << 8) | (chunk[2] << 16) | (chunk[3] << 24))
            c = (
                t[7][c0 & 0xFF]
                ^ t[6][(c0 >> 8) & 0xFF]
                ^ t[5][(c0 >> 16) & 0xFF]
                ^ t[4][(c0 >> 24) & 0xFF]
                ^ t[3][chunk[4]]
                ^ t[2][chunk[5]]
                ^ t[1][chunk[6]]
                ^ t[0][chunk[7]]
            )
            i += 8
        while i < n:
            c = _TABLE[(c ^ buf[i]) & 0xFF] ^ (c >> 8)
            i += 1
    return int(c ^ np.uint32(0xFFFFFFFF))


def crc32c_bulk(rows: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """CRC-32C of each row of a (B, N) uint8 array, row i over its first
    lengths[i] bytes.  Vectorized across rows (one table lookup per byte
    position, all rows at once) — the numpy analog of the device kernel's
    batch layout."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    B, N = rows.shape
    lengths = np.asarray(lengths, dtype=np.int64)
    c = np.full(B, 0xFFFFFFFF, dtype=np.uint32)
    alive_len = lengths
    for j in range(N):
        active = j < alive_len
        if not active.any():
            break
        nxt = _TABLE[(c ^ rows[:, j]) & 0xFF] ^ (c >> np.uint32(8))
        c = np.where(active, nxt, c)
    return c ^ np.uint32(0xFFFFFFFF)


# GF(2) helpers used to build the device CRC kernel's constant matrices.

def _crc_shift1_matrix() -> np.ndarray:
    """32x32 GF(2) matrix for advancing the (reflected, LSB-first) CRC
    register by one zero bit: c' = (c >> 1) ^ (poly if c&1 else 0)."""
    m = np.zeros((32, 32), dtype=np.uint8)
    for j in range(32):
        c = 1 << j
        c = (c >> 1) ^ (CRC32C_POLY_REFLECTED if (c & 1) else 0)
        for i in range(32):
            m[i, j] = (c >> i) & 1
    return m


_SHIFT1 = _crc_shift1_matrix()


def gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.astype(np.int64) @ b.astype(np.int64)) % 2


def crc_shift_matrix(nbits: int) -> np.ndarray:
    """32x32 GF(2) matrix M such that M @ crc_bits == crc advanced by
    nbits zero bits (exponentiation by squaring of the 1-bit matrix)."""
    result = np.eye(32, dtype=np.uint8)
    base = _SHIFT1
    n = nbits
    while n:
        if n & 1:
            result = gf2_matmul(base, result).astype(np.uint8)
        base = gf2_matmul(base, base).astype(np.uint8)
        n >>= 1
    return result


def crc_combine(crc_a: int, crc_b: int, len_b: int) -> int:
    """crc32c(A+B) from crc32c(A), crc32c(B), len(B).

    Because the init value equals the final-xor value (both 0xffffffff),
    the conditioning terms cancel and the identity is simply
    crc(AB) = shift(crc(A), 8*len_b) ^ crc(B), with shift = advancing the
    finalized register through len_b zero bytes (a GF(2) linear map).
    """
    if len_b == 0:
        return crc_a
    m = crc_shift_matrix(8 * len_b)
    bits = np.array([(crc_a >> i) & 1 for i in range(32)], dtype=np.uint8)
    shifted = (m @ bits) % 2
    a_shift = int(sum(int(b) << i for i, b in enumerate(shifted)))
    return a_shift ^ crc_b
