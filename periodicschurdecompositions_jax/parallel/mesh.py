"""Multi-device execution: batch-sharded decompositions over a Mesh.

The reference has no parallelism (SURVEY.md §2 checklist); these are
green-field components.  The natural parallel axes for periodic Schur
workloads are:

* ``batch``: independent problems (parameter sweeps, ensembles of cycles) —
  pure data parallelism via vmap + NamedSharding; zero communication.
* ``cycle``: the p factors form a ring; operator application pipelines
  around it with ``ppermute`` (see :mod:`.ring`).

Dense QR/QZ iterations are sequential in their critical path, so batching
(vmap) plus cross-device problem sharding is the high-throughput
configuration; the ring layer accelerates the Krylov (matvec-dominated) path.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, names=("batch",),
              shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a device mesh (defaults to 1-D over all available devices).

    Raises ValueError when fewer than ``n_devices`` devices exist.
    """
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    if shape is None:
        shape = (len(devs),) + (1,) * (len(names) - 1)
    arr = np.array(devs).reshape(shape)
    return Mesh(arr, names)


def batched_pschur_real(A_batch: jax.Array, mesh: Optional[Mesh] = None,
                        axis: str = "batch", want_z: bool = True,
                        maxitfac: int = 30):
    """Batched real periodic Schur: A_batch (B, p, n, n) -> stacked results.

    Each batch lane runs the full jitted QR core; lanes deflate
    independently (the cores' loop bodies freeze converged lanes, so a
    batched while_loop is exact).  With a mesh, lanes shard over ``axis``
    and run embarrassingly parallel across devices.

    Returns (T, Z, wr, wi, ok) with a leading batch axis.
    """
    from ..ops.pqr_real import pqr_real_core
    from ..ops.hessenberg import phessenberg_core

    def one(A):
        H, Q = phessenberg_core(A, want_q=want_z)
        return pqr_real_core(H, Z=Q, want_z=want_z, maxitfac=maxitfac)

    fn = jax.vmap(one)
    if mesh is not None:
        spec = NamedSharding(mesh, P(axis))
        A_batch = jax.device_put(A_batch, spec)
        fn = jax.jit(fn, in_shardings=(spec,))
    else:
        fn = jax.jit(fn)
    return fn(A_batch)


def batched_pschur_complex(A_batch: jax.Array, S, mesh: Optional[Mesh] = None,
                           axis: str = "batch", want_z: bool = True,
                           maxitfac: int = 30):
    """Batched complex periodic QZ over a problem batch (see above)."""
    from ..ops.pqz_complex import pqz_complex_core
    from ..ops.hessenberg import phessenberg_core, phessenberg_signed_core
    S = tuple(bool(x) for x in S)

    def one(A):
        if all(S):
            H, Q = phessenberg_core(A, want_q=want_z)
        else:
            H, Q = phessenberg_signed_core(A, S, want_q=want_z)
        return pqz_complex_core(H, S, Z=Q, want_z=want_z, maxitfac=maxitfac)

    fn = jax.vmap(one)
    if mesh is not None:
        spec = NamedSharding(mesh, P(axis))
        A_batch = jax.device_put(A_batch, spec)
        fn = jax.jit(fn, in_shardings=(spec,))
    else:
        fn = jax.jit(fn)
    return fn(A_batch)
