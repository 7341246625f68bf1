"""Shared jnp kernel helpers: byte shifting, scans, scatter/gather
utilities, and the Rabin-Karp hash constants.

Everything here is shape-static and jit-friendly; the same code runs on
the CPU backend (tests) and the accelerator (production).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Two independent odd multipliers for the paired u32 rolling hash.  u32
# wraparound needs no x64 mode (u64 is x64-gated in JAX); the pair gives
# ~2^-64 collision odds per comparison, and every emitted copy is exactly
# verified afterwards regardless.
R_A = np.uint32(0x01000193)  # FNV-32 prime
R_B = np.uint32(0x85EBCA77)  # Murmur3 c1 (odd)

_MAX_POW = 1 << 17  # covers any block/stream segment we hash


@functools.lru_cache(maxsize=None)
def _pow_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """R^i and R^-i mod 2^32 for both multipliers, as baked constants."""
    out = []
    for r in (R_A, R_B):
        pw = np.empty(_MAX_POW, dtype=np.uint32)
        pw[0] = 1
        with np.errstate(over="ignore"):
            np.multiply.accumulate(np.full(_MAX_POW - 1, r, dtype=np.uint32), out=pw[1:])
            x = r
            for _ in range(5):
                x = x * (np.uint32(2) - r * x)
            ipw = np.empty(_MAX_POW, dtype=np.uint32)
            ipw[0] = 1
            np.multiply.accumulate(np.full(_MAX_POW - 1, x, dtype=np.uint32), out=ipw[1:])
        out += [pw, ipw]
    return tuple(out)  # type: ignore[return-value]


def prefix_hashes(b_u32: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """H[i] = hash of b[:i] for both multipliers, via the closed form
    H[i] = Rinv^{n-i} * cumsum(b[j] * R^{n-1-j})  (one cumsum, no scan
    carry).  Returns (Ha, Hb), each of length n+1, dtype uint32."""
    n = b_u32.shape[0]
    pa, ipa, pb, ipb = _pow_tables()
    out = []
    for pw, ipw in ((pa, ipa), (pb, ipb)):
        rp = jnp.asarray(pw[: n + 1])
        rip = jnp.asarray(ipw[: n + 1])
        weighted = b_u32.astype(jnp.uint32) * rp[n - 1 :: -1][:n]
        s = jnp.concatenate([jnp.zeros(1, jnp.uint32), jnp.cumsum(weighted, dtype=jnp.uint32)])
        out.append(s * rip[n::-1])
    return out[0], out[1]


def shifted(b: jnp.ndarray, k: int, fill=0) -> jnp.ndarray:
    """b shifted left by k with fill (static k): out[i] = b[i+k]."""
    if k == 0:
        return b
    return jnp.concatenate([b[k:], jnp.full((k,), fill, b.dtype)])


def exclusive_cumsum(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([jnp.zeros(1, x.dtype), jnp.cumsum(x)[:-1]])


def mark_orbit(nxt: jnp.ndarray, start: jnp.ndarray, rounds: int) -> jnp.ndarray:
    """Boolean mask of positions reachable from `start` by iterating the
    successor function `nxt` (pointer doubling with early exit; `rounds`
    bounds the worst case >= log2(orbit)).

    nxt values must satisfy nxt[p] > p, with `size` acting as the
    absorbing out-of-range sentinel.  Gathers are the expensive
    primitive here, so the loop exits as soon as a round adds no new
    marks (typical streams converge in ~log2(#tags) ~ 12 rounds, and the
    convergence check is a cheap reduction).
    """
    size = nxt.shape[0]
    jump = jnp.clip(nxt, 0, size)
    jump = jnp.concatenate([jump, jnp.array([size])])  # absorbing slot
    mark = jnp.zeros(size + 1, dtype=bool).at[jnp.clip(start, 0, size)].set(True)

    def cond(state):
        i, changed, mark, jump = state
        return changed & (i < rounds)

    def body(state):
        i, _, mark, jump = state
        targets = jnp.where(mark, jump, size)
        new_mark = mark.at[targets].max(mark, mode="drop")
        changed = jnp.any(new_mark != mark)
        jump = jump[jnp.clip(jump, 0, size)]
        jump = jump.at[size].set(size)
        return i + 1, changed, new_mark, jump

    _, _, mark, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.bool_(True), mark, jump)
    )
    return mark[:size]


def mark_orbits2(nxt2: jnp.ndarray, start: jnp.ndarray, rounds: int) -> jnp.ndarray:
    """mark_orbit for TWO successor functions in one doubling loop.

    nxt2: int32[2, size] with values in [p+1, size] (size = absorbing).
    Rows are laid out flat with one sentinel slot between them so jumps
    cannot leak across rows; returns bool[2, size].  Halves the gather
    rounds vs two separate orbit calls (the parse runs greedy and lazy
    strategies over the same match data)."""
    size = nxt2.shape[1]
    w = size + 1  # row stride; slot `size` within each row absorbs
    flat = jnp.clip(nxt2, 0, size) + jnp.array([[0], [w]], jnp.int32)
    jump = jnp.concatenate(
        [flat[0], jnp.array([size]), flat[1], jnp.array([w + size])]
    )
    # absorbing slots: size and w+size point to themselves
    jump = jump.at[size].set(size).at[w + size].set(w + size)
    mark = jnp.zeros(2 * w, dtype=bool)
    mark = mark.at[jnp.clip(start, 0, size)].set(True)
    mark = mark.at[w + jnp.clip(start, 0, size)].set(True)

    def cond(state):
        i, changed, mark, jump = state
        return changed & (i < rounds)

    def body(state):
        i, _, mark, jump = state
        targets = jnp.where(mark, jump, size)  # size absorbs row-0 junk
        new_mark = mark.at[targets].max(mark, mode="drop")
        changed = jnp.any(new_mark != mark)
        jump = jump[jnp.clip(jump, 0, 2 * w - 1)]
        return i + 1, changed, new_mark, jump

    _, _, mark, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.bool_(True), mark, jump)
    )
    return jnp.stack([mark[:size], mark[w : w + size]])


def resolve_pointers(ptr: jnp.ndarray, rounds: int) -> jnp.ndarray:
    """Pointer doubling until every entry is negative (literal-resolved).
    Negative entries are terminal; non-negative entries chase ptr[ptr].
    Early exit: real streams resolve in ~2-4 rounds (copy chains are
    shallow); worst-case RLE needs log2(len)."""

    def cond(state):
        i, p = state
        return jnp.any(p >= 0) & (i < rounds)

    def body(state):
        i, p = state
        chased = p[jnp.clip(p, 0, p.shape[0] - 1)]
        return i + 1, jnp.where(p >= 0, chased, p)

    _, p = jax.lax.while_loop(cond, body, (jnp.int32(0), ptr))
    return p


def segment_ids_from_starts(starts: jnp.ndarray, valid: jnp.ndarray, size: int) -> jnp.ndarray:
    """Given sorted segment start offsets (with validity mask), label each
    of `size` positions with its segment index (scatter + cummax)."""
    marks = jnp.zeros(size, dtype=jnp.int32)
    idx = jnp.where(valid, starts, size)
    marks = marks.at[idx].add(1, mode="drop")
    return jnp.cumsum(marks) - 1


def bytes_to_u32_words(b: jnp.ndarray) -> jnp.ndarray:
    """Little-endian 4-gram value at every position (padded with zeros)."""
    b32 = b.astype(jnp.uint32)
    return (
        b32
        | (shifted(b32, 1) << 8)
        | (shifted(b32, 2) << 16)
        | (shifted(b32, 3) << 24)
    )
