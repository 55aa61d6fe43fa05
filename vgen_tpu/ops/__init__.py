"""Device-side compute (plain jnp/lax, compiled by XLA).

Layout convention: big integers are arrays of 16-bit limbs stored in uint32,
shape ``(n_limbs, *batch)`` -- limbs on the leading axis, batch on the
minor one, so all limb arithmetic is elementwise across the batch.
"""
