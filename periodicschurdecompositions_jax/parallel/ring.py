"""Cycle-ring pipeline: factor-sharded operator application across devices.

The p factors of a periodic problem form a ring (SURVEY.md §5): applying the
cyclic product to vectors walks factor 0, 1, ..., p-1.  Sharding the factor
axis over a mesh axis and rotating the running vectors with
``lax.ppermute`` turns this walk into a pipeline — the direct analogue of
ring attention's neighbor exchange, with one factor shard per device.

A single vector gives no parallelism (the walk is sequential), but the
periodic Krylov process needs the product's *cyclic rotations* too: block b
started on device d accumulates ``A[(d+1)K-1] ... A[dK]``-style partial
products, so after D hops every device has applied its local factors to
every block — all D cyclic rotations of the product computed in one
pipelined pass with every link busy.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P


def ring_cycle_products(A: jax.Array, V: jax.Array, mesh: Mesh,
                        axis: str = "cycle"):
    """All cyclic partial products applied to per-device vector blocks.

    Args:
      A: (p, n, n) factor stack, sharded (or shardable) over ``axis`` — p
         must be divisible by the mesh axis size D; device d holds factors
         [dK, (d+1)K), K = p/D.
      V: (D, n, b) vector blocks; block d lives on device d.
      mesh: device mesh containing ``axis``.

    Returns:
      (D, n, b) result blocks: block d has been multiplied, in ring order,
      by ALL p factors starting from factor dK (i.e. the cyclic rotation
      ``A[dK-1] ... A[0] A[p-1] ... A[dK]`` in left-to-right application
      order factor dK first).  Block d ends up back on device d.
    """
    D = mesh.shape[axis]
    p, n, _ = A.shape
    assert p % D == 0, "cycle length must divide the mesh axis"

    def local(Ashard, Vblk):
        # Ashard: (K, n, n) local factors; Vblk: (1, n, b)
        K = Ashard.shape[0]
        v = Vblk[0]

        def apply_local(v):
            def stepf(k, v):
                return Ashard[k] @ v
            return lax.fori_loop(0, K, stepf, v)

        def hop(d, v):
            v = apply_local(v)
            # send to the next device on the ring (factor order ascending)
            perm = [(i, (i + 1) % D) for i in range(D)]
            return lax.ppermute(v, axis, perm)

        v = lax.fori_loop(0, D, hop, v)
        return v[None]

    fn = shard_map(local, mesh=mesh, in_specs=(P(axis), P(axis)),
                   out_specs=P(axis))
    return fn(A, V)


def ring_product_apply(A: jax.Array, v: jax.Array, mesh: Mesh,
                       axis: str = "cycle"):
    """Apply the full left product ``A[p-1] @ ... @ A[0]`` to v (n,) or (n, b).

    Factor-sharded walk around the ring; only one device computes per hop
    (latency-bound — use :func:`ring_cycle_products` for pipelined batches).
    """
    D = mesh.shape[axis]
    p, n, _ = A.shape
    assert p % D == 0
    vin = v if v.ndim == 2 else v[:, None]

    def local(Ashard, vrep):
        K = Ashard.shape[0]
        me = lax.axis_index(axis)
        # mark the carry device-varying for the shard_map vma type system
        v0 = lax.pcast(vrep, (axis,), to="varying")

        def hop(d, v):
            def apply_local(v):
                def stepf(k, v):
                    return Ashard[k] @ v
                return lax.fori_loop(0, K, stepf, v)
            applied = apply_local(v)
            # broadcast the active device's result to everyone
            contrib = jnp.where(me == d, applied, jnp.zeros_like(applied))
            # psum replicates; re-mark varying to keep the carry type stable
            return lax.pcast(lax.psum(contrib, axis), (axis,), to="varying")

        out = lax.fori_loop(0, D, hop, v0)
        return out[None]

    fn = shard_map(local, mesh=mesh, in_specs=(P(axis), P()),
                   out_specs=P(axis))
    out = fn(A, vin)[0]
    return out if v.ndim == 2 else out[:, 0]
