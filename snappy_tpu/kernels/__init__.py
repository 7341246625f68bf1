"""L1 kernels: parallel codec algorithms.

encode_np / decode_np are the numpy reference implementations of the
parallel (vectorizable) algorithms; encode_jnp / decode_jnp are the
jax/XLA versions of exactly the same algorithms; crc32c_jnp is the
device CRC-32C.  All are tested for identical behavior.
"""
