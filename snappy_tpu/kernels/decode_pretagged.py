"""Hybrid decoder: host-parsed tags, device byte materialization.

SURVEY.md §7.3.1 sanctions parsing the element stream on the host
("commands are ~12% of bytes; positions are cheap to compute serially
at ~GB/s in C++") — the native sn_parse_tags walker emits fixed-width
validated records, and this kernel skips the two most expensive device
stages of the pure-device decoder (speculative per-position parse and
the tag-orbit doubling), keeping only the per-byte copy resolution:

    records -> per-byte segment labels -> source pointers ->
    pointer-doubling -> one gather

Roughly halves the device gather traffic vs decode_jnp.  The runtime
routes framed decode to the id path whenever the native library is
present, so this kernel is no longer selected by device_codec
(SNAPPY_TPU_HOST_PARSE=0 forced the pure-device path when it was).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from snappy_tpu.kernels.common_jnp import resolve_pointers

__all__ = ["decode_blocks_pretagged"]


def _decode_one(comp, recs, n_tags, dst_len, out_max: int, ptr_rounds: int):
    t_max = recs.shape[0]
    kind = recs[:, 0]
    out_len = recs[:, 1]
    arg = recs[:, 2]  # offset (copies) / literal source position (literals)
    out_start = recs[:, 3]
    t_valid = jnp.arange(t_max, dtype=jnp.int32) < n_tags

    startmarks = jnp.zeros(out_max, dtype=jnp.int32)
    safe_starts = jnp.where(t_valid & (out_start < out_max), out_start, out_max)
    startmarks = startmarks.at[safe_starts].add(1, mode="drop")
    tid_b = jnp.clip(jnp.cumsum(startmarks) - 1, 0, t_max - 1)

    j = jnp.arange(out_max, dtype=jnp.int32)
    rel = j - out_start[tid_b]
    lit_b = kind[tid_b] == 0
    ptr = jnp.where(lit_b, -(arg[tid_b] + rel) - 1, j - arg[tid_b])
    ptr = jnp.where(j < dst_len, ptr, -1)

    ptr = resolve_pointers(ptr, ptr_rounds)
    out = comp[jnp.clip(-ptr - 1, 0, comp.shape[0] - 1)].astype(jnp.uint8)
    out = jnp.where(j < dst_len, out, 0)
    return out


@functools.partial(jax.jit, static_argnames=("out_max", "ptr_rounds"))
def decode_blocks_pretagged(comp, recs, n_tags, dst_len, out_max: int = 65536,
                            ptr_rounds: int = 17):
    """comp: uint8[B, CMAX]; recs: int32[B, T_MAX, 4] host-parsed records
    (kind, out_len, offset|lit_src, out_start — already validated);
    n_tags: int32[B]; dst_len: int32[B].  Returns uint8[B, out_max]."""
    fn = functools.partial(_decode_one, out_max=out_max, ptr_rounds=ptr_rounds)
    return jax.vmap(fn)(comp, recs, n_tags, dst_len)
