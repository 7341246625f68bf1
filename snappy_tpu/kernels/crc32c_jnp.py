"""CRC-32C on the device: checksum as GF(2) matrix multiplication.

CRC is linear over GF(2), so the checksum of a 64 KiB chunk factors into
two matmuls (SURVEY.md §7.3.5):

  1. split the chunk into S=256 segments of L=256 bytes; unpack to bits;
     segment CRCs = bits[S, 8L] @ B[8L, 32]  (mod 2)   -- one matmul
  2. combine: crc = concat(segcrcs)[S*32] @ P[S*32, 32] (mod 2) ^ const
     (P folds the per-position zero-shift matrices M_{8L(S-1-s)})

Chunks shorter than 64 KiB are zero-SUFFIX padded on device and the
length adjustment crc(m) = Minv_{8k}(crc(m||0^k) ^ crc(0^k)) is applied
with 17 tiny selective matvecs (binary decomposition of k).

The two big matmuls take bf16 0/1 operands with f32 accumulation
(products are 0/1; sums <= 8192 are exact in f32), so the matrix units
do the heavy lifting; the mod-2 is one elementwise AND.  The float32
matvecs of the length adjustment ask for Precision.HIGHEST so that no
backend may round their operands (e.g. to TF32); with 0/1 operands and
sums <= 32 they are exact either way.  Validated bit-exact against the
table oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from snappy_tpu.spec.crc32c import (
    _TABLE,
    crc32c as crc_oracle,
    crc_shift_matrix,
    gf2_matmul,
)

SEG = 256  # segment length in bytes
NSEG = 256  # segments per 64 KiB chunk
CHUNK = SEG * NSEG


def _crc_affine_const(n: int) -> int:
    """crc32c of n zero bytes."""
    return crc_oracle(b"\x00" * n)


@functools.lru_cache(maxsize=None)
def _constants():
    """Build (B_seg[2048, 32], P_comb[NSEG*32, 32], const_u32,
    minv[17, 32, 32], zero_crc_table[CHUNK+1])."""
    # Segment matrix: column k of crc bits vs input bit j of the segment.
    # crc(seg) = z ^ XOR_j bit_j * (crc(e_j) ^ z), z = crc(0^SEG).
    z = _crc_affine_const(SEG)
    B = np.zeros((SEG * 8, 32), dtype=np.uint8)
    # contribution of byte i, bit b: crc of segment with only that bit set
    # = table-free computation via linearity: crc(e_{i,b}) ^ z.
    # Compute efficiently: for each byte position i, the 8 basis values.
    for i in range(SEG):
        for b in range(8):
            msg = bytearray(SEG)
            msg[i] = 1 << b
            v = crc_oracle(bytes(msg)) ^ z
            for out_bit in range(32):
                B[i * 8 + b, out_bit] = (v >> out_bit) & 1

    # Combination: crc(m) = XOR_s M_s @ crc(seg_s) where
    # M_s = shift by 8*SEG*(NSEG-1-s) zero bytes (finalized-space shift).
    P = np.zeros((NSEG * 32, 32), dtype=np.uint8)
    for s in range(NSEG):
        M = crc_shift_matrix(8 * SEG * (NSEG - 1 - s))
        # crc_bits_out = M @ crc_bits_in  ->  row-major: out[o] = sum_i M[o,i]*in[i]
        P[s * 32 : (s + 1) * 32, :] = M.T
    # constant: contributions of the per-segment z constants
    const = 0
    for s in range(NSEG):
        M = crc_shift_matrix(8 * SEG * (NSEG - 1 - s))
        zb = np.array([(z >> i) & 1 for i in range(32)], dtype=np.uint8)
        vb = (M @ zb) % 2
        const ^= int(sum(int(x) << i for i, x in enumerate(vb)))

    # inverse shift matrices for 2^j bits of zero-suffix removal
    minv = np.zeros((17, 32, 32), dtype=np.uint8)
    for j in range(17):
        M = crc_shift_matrix(8 * (1 << j))
        # GF(2) inverse via Gauss-Jordan
        A = np.concatenate([M.astype(np.uint8), np.eye(32, dtype=np.uint8)], axis=1)
        for col in range(32):
            piv = col + np.argmax(A[col:, col])
            A[[col, piv]] = A[[piv, col]]
            for r in range(32):
                if r != col and A[r, col]:
                    A[r] ^= A[col]
        minv[j] = A[:, 32:]

    zero_crc = np.zeros(CHUNK + 1, dtype=np.uint32)
    c = np.uint32(0xFFFFFFFF)
    for n in range(1, CHUNK + 1):
        c = _TABLE[(c ^ np.uint32(0)) & 0xFF] ^ (c >> np.uint32(8))
        zero_crc[n] = c ^ np.uint32(0xFFFFFFFF)
    return B, P, const, minv, zero_crc


@functools.partial(jax.jit, static_argnames=())
def crc32c_chunks(chunks: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """Batched CRC-32C of uint8[B, 65536] rows over their first
    lengths[b] bytes.  Returns uint32[B]."""
    B_np, P_np, const, minv_np, zero_np = _constants()
    Bm = jnp.asarray(B_np, jnp.bfloat16)
    Pm = jnp.asarray(P_np, jnp.bfloat16)
    minv = jnp.asarray(minv_np, jnp.float32)
    zero_crc = jnp.asarray(zero_np)

    nb, width = chunks.shape
    assert width == CHUNK, f"chunk rows must be {CHUNK} wide"
    pos = jnp.arange(CHUNK, dtype=jnp.int32)
    data = jnp.where(pos[None, :] < lengths[:, None], chunks, 0)

    # bits: [B, NSEG, SEG*8] in bf16
    d32 = data.astype(jnp.int32).reshape(nb, NSEG, SEG)
    shifts = jnp.arange(8, dtype=jnp.int32)
    bits = ((d32[..., :, None] >> shifts) & 1).astype(jnp.bfloat16)
    bits = bits.reshape(nb, NSEG, SEG * 8)

    seg = jax.lax.dot_general(
        bits, Bm, (((2,), (0,)), ((), ())), preferred_element_type=jnp.float32
    )
    seg = seg.astype(jnp.int32) & 1  # [B, NSEG, 32] mod 2
    flat = seg.reshape(nb, NSEG * 32).astype(jnp.bfloat16)
    crc_bits = jax.lax.dot_general(
        flat, Pm, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32
    )
    crc_bits = (crc_bits.astype(jnp.int32) & 1)  # [B, 32]
    const_bits = jnp.array(
        [(const >> i) & 1 for i in range(32)], dtype=jnp.int32
    )
    crc_bits = crc_bits ^ const_bits[None, :]

    # length adjustment: remove k = CHUNK - length zero-suffix bytes
    k = (CHUNK - lengths).astype(jnp.int32)
    zc = zero_crc[jnp.clip(k, 0, CHUNK)]
    zc_bits = ((zc[:, None] >> jnp.arange(32, dtype=jnp.uint32)[None, :]) & 1).astype(
        jnp.int32
    )
    c = crc_bits ^ zc_bits

    def step(j, c):
        apply = ((k >> j) & 1) == 1
        cf = c.astype(jnp.float32)
        nxt = jax.lax.dot_general(
            cf, minv[j], (((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        ).astype(jnp.int32) & 1
        return jnp.where(apply[:, None], nxt, c)

    c = jax.lax.fori_loop(0, 17, step, c)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, :]
    return jnp.sum(c.astype(jnp.uint32) * weights, axis=1, dtype=jnp.uint32)
