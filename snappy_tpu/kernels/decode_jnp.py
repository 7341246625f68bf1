"""Parallel Snappy decoder — jax/XLA implementation.

The jnp mirror of kernels/decode_np.py (same algorithm, shape-static and
batched): speculative per-position tag parse -> orbit marking by pointer
doubling -> per-output-byte source pointers -> pointer-doubling copy
resolution -> one gather.  Runs identically on every JAX backend.

Layout: a batch of B independent blocks, each a row of a padded
[B, CMAX] uint8 array.  Everything is vmapped over rows; XLA fuses the
elementwise stages and batches the gathers.  Validation does not raise
on device: each block returns an error code (0 = OK), and the host layer
maps codes to the CorruptError surface (SURVEY.md §8.3).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from snappy_tpu.errors import CorruptError
from snappy_tpu.kernels.common_jnp import (
    exclusive_cumsum,
    mark_orbit,
    resolve_pointers,
    shifted,
)

__all__ = ["decode_block_jnp", "decode_blocks", "ERR_NONE", "ERR_MESSAGES"]

ERR_NONE = 0
ERR_OVERRUN_INPUT = 1
ERR_SIZE_MISMATCH = 2
ERR_OVERRUN_OUTPUT = 3
ERR_BAD_OFFSET = 4
ERR_LITERAL_OVERRUN = 5

ERR_MESSAGES = {
    ERR_OVERRUN_INPUT: "element overruns input",
    ERR_SIZE_MISMATCH: "decoded size differs from preamble",
    ERR_OVERRUN_OUTPUT: "element overruns output",
    ERR_BAD_OFFSET: "zero copy offset or offset before block start",
    ERR_LITERAL_OVERRUN: "literal overruns input",
}


def _parse_positions(comp: jnp.ndarray):
    """Speculative tag parse at every byte position (vector ops only)."""
    n = comp.shape[0]
    b0 = comp.astype(jnp.int32)
    b1 = shifted(b0, 1)
    b2 = shifted(b0, 2)
    b3 = shifted(b0, 3)
    b4 = shifted(b0, 4)

    tag = b0 & 3
    x = b0 >> 2

    lit_hdr = jnp.select([x < 60, x == 60, x == 61, x == 62], [1, 2, 3, 4], 5)
    lit_len = (
        jnp.select(
            [x < 60, x == 60, x == 61, x == 62],
            [x, b1, b1 | (b2 << 8), b1 | (b2 << 8) | (b3 << 16)],
            b1 | (b2 << 8) | (b3 << 16) | (b4 << 24),
        )
        + 1
    )

    is_lit = tag == 0
    is_c1 = tag == 1
    is_c2 = tag == 2

    hdr = jnp.select([is_lit, is_c1, is_c2], [lit_hdr, 2, 3], 5)
    out_len = jnp.select([is_lit, is_c1], [lit_len, 4 + ((b0 >> 2) & 7)], 1 + x)
    offset = jnp.select(
        [is_lit, is_c1, is_c2],
        [jnp.zeros_like(b0), ((b0 & 0xE0) << 3) | b1, b1 | (b2 << 8)],
        b1 | (b2 << 8) | (b3 << 16) | (b4 << 24),
    )
    pos = jnp.arange(n, dtype=jnp.int32)
    nxt = pos + jnp.where(is_lit, lit_hdr + lit_len, hdr)
    # Poison literals whose length field would overflow int32 (>= 2^30):
    # no block this decoder handles can contain them, and letting them
    # wrap would corrupt the successor walk.  Forcing nxt past the end
    # surfaces as ERR_OVERRUN_INPUT, matching the oracle's CorruptError.
    poison = is_lit & (x == 63) & (b4 >= 0x40)
    nxt = jnp.where(poison, n + 1, nxt)
    lit_src = pos + lit_hdr
    return nxt, out_len, offset, lit_src, is_lit


def _decode_one(comp, start, comp_len, dst_len, out_max: int, tag_rounds: int, ptr_rounds: int):
    """Decode one padded block; returns (out[out_max] u8, err i32)."""
    cmax = comp.shape[0]
    # Mask bytes past comp_len so padding can't fabricate elements.
    pos = jnp.arange(cmax, dtype=jnp.int32)
    comp = jnp.where(pos < comp_len, comp, 0)

    nxt, out_len, offset, lit_src, is_lit = _parse_positions(comp)
    # Successor clamps: a tag overrunning comp_len never marks further.
    nxt_c = jnp.where(nxt <= comp_len, nxt, cmax)
    # Force progress (corrupt streams can't loop: nxt > pos always holds
    # since hdr >= 1, but keep a floor for safety).
    nxt_c = jnp.maximum(nxt_c, pos + 1)

    reached = mark_orbit(nxt_c, start, tag_rounds) & (pos < comp_len)

    # Walk must consume the input exactly: the last reached element's
    # successor must be comp_len (detect truncation / overrun).
    any_reached = jnp.any(reached)
    last_pos = jnp.max(jnp.where(reached, pos, -1))
    ends_ok = any_reached & (nxt[jnp.clip(last_pos, 0, cmax - 1)] == comp_len)
    # An empty stream (dst_len 0, no elements) is valid.
    ends_ok = ends_ok | ((dst_len == 0) & (start == comp_len))

    # Order tags by position: tid = rank among reached.
    tid = jnp.cumsum(reached.astype(jnp.int32)) - 1
    t_max = cmax // 2 + 2
    tag_pos = jnp.full(t_max, cmax, dtype=jnp.int32)
    tag_pos = tag_pos.at[jnp.where(reached, tid, t_max)].set(pos, mode="drop")
    n_tags = jnp.sum(reached.astype(jnp.int32))
    t_valid = jnp.arange(t_max) < n_tags

    def g(arr, fill):
        return jnp.where(t_valid, arr[jnp.clip(tag_pos, 0, cmax - 1)], fill)

    t_out = g(out_len, 0)
    t_off = g(offset, 1)
    t_lit = g(lit_src, 0)
    t_islit = g(is_lit, True)

    out_start = exclusive_cumsum(t_out)
    total = jnp.sum(t_out)

    err = jnp.int32(ERR_NONE)
    err = jnp.where(~ends_ok, ERR_OVERRUN_INPUT, err)
    err = jnp.where(total != dst_len, ERR_SIZE_MISMATCH, err)
    err = jnp.where(
        jnp.any(t_valid & (t_out > dst_len - out_start)), ERR_OVERRUN_OUTPUT, err
    )
    err = jnp.where(
        jnp.any(t_valid & ~t_islit & ((t_off <= 0) | (t_off > out_start))),
        ERR_BAD_OFFSET,
        err,
    )
    err = jnp.where(
        jnp.any(t_valid & t_islit & (t_lit + t_out > comp_len)),
        ERR_LITERAL_OVERRUN,
        err,
    )

    # Per-output-byte tag labels.
    startmarks = jnp.zeros(out_max, dtype=jnp.int32)
    safe_starts = jnp.where(t_valid & (out_start < out_max), out_start, out_max)
    startmarks = startmarks.at[safe_starts].add(1, mode="drop")
    tid_b = jnp.cumsum(startmarks) - 1
    tid_b = jnp.clip(tid_b, 0, t_max - 1)

    j = jnp.arange(out_max, dtype=jnp.int32)
    rel = j - out_start[tid_b]
    lit_b = t_islit[tid_b]
    ptr = jnp.where(lit_b, -(t_lit[tid_b] + rel) - 1, j - t_off[tid_b])
    # out-of-range output positions: point at input 0 (masked later)
    ptr = jnp.where(j < dst_len, ptr, -1)

    ptr = resolve_pointers(ptr, ptr_rounds)
    out = comp[jnp.clip(-ptr - 1, 0, cmax - 1)].astype(jnp.uint8)
    out = jnp.where(j < dst_len, out, 0)
    return out, err


@functools.partial(jax.jit, static_argnames=("out_max", "tag_rounds", "ptr_rounds"))
def decode_blocks(comp, start, comp_len, dst_len, out_max: int = 65536,
                  tag_rounds: int = 17, ptr_rounds: int = 17):
    """Batched parallel decode.

    comp:      uint8[B, CMAX]   padded compressed blocks (element streams,
                                no varint preamble)
    start:     int32[B]         first element offset within each row
    comp_len:  int32[B]         valid bytes per row
    dst_len:   int32[B]         expected decoded length per row
    returns    (uint8[B, out_max], int32[B] error codes)
    """
    fn = functools.partial(
        _decode_one, out_max=out_max, tag_rounds=tag_rounds, ptr_rounds=ptr_rounds
    )
    return jax.vmap(fn)(comp, start, comp_len, dst_len)


def _bucket(n: int, floor: int = 256) -> int:
    """Round a shape up to the next power of two (>= floor) so jit
    compilations are reused across nearby sizes."""
    b = floor
    while b < n:
        b *= 2
    return b


def decode_block_jnp(comp_bytes: bytes, dst_len: int, start: int = 0) -> bytes:
    """Single-block convenience wrapper (used by tests and the runtime's
    small-input path).  Raises CorruptError per the shared error surface."""
    import numpy as np

    n = len(comp_bytes)
    cmax = _bucket(max(8, n))
    comp = np.zeros((1, cmax), dtype=np.uint8)
    comp[0, :n] = np.frombuffer(comp_bytes, dtype=np.uint8)
    out_max = _bucket(max(8, dst_len))
    # doubling-round bounds scale with the stream size (large raw
    # streams can have >2^17 elements / copy-chain depth); the loops
    # early-exit, so generous bounds cost nothing on typical data
    rounds = max(17, cmax.bit_length() + 1, out_max.bit_length() + 1)
    out, err = decode_blocks(
        jnp.asarray(comp),
        jnp.array([start], jnp.int32),
        jnp.array([n], jnp.int32),
        jnp.array([dst_len], jnp.int32),
        out_max=out_max,
        tag_rounds=rounds,
        ptr_rounds=rounds,
    )
    err_code = int(err[0])
    if err_code != ERR_NONE:
        raise CorruptError(ERR_MESSAGES.get(err_code, f"error {err_code}"))
    return bytes(np.asarray(out[0, :dst_len]).tobytes())
