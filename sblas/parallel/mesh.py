"""Device mesh construction and operand placement.

Replacement for the reference's eager copy-based distribution
(`sync2gpu(n_gpu, policy)` with cudaMemcpy per device, matrix.h:341-395,
554-568) and its OpenMP thread-per-GPU runtime (spmm.h:101-104): here a
`jax.sharding.Mesh` names the device axis, placement is a `NamedSharding`
annotation, and SPMD execution happens inside `jax.jit`/`jax.shard_map` —
XLA moves the bytes.

Multi-host: `init_distributed()` wraps `jax.distributed.initialize`; meshes
built from `jax.devices()` then span all hosts (the reference is
single-node only, README.md:28).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..containers import SharePolicy
from ..utils.errors import PartitionError, require

DEFAULT_AXIS = "shards"


def make_mesh(n_devices: Optional[int] = None,
              axis: str = DEFAULT_AXIS) -> Mesh:
    """1-D mesh over the first `n_devices` devices (all by default).

    The analog of the reference's `n_gpu` argument threaded through every
    ctor (spmm_test.cu:108)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    require(n <= len(devs), PartitionError,
            f"requested {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (axis,))


def init_distributed(**kwargs) -> None:
    """Multi-host process bootstrap (`jax.distributed.initialize`).

    Idempotent when the process group is already up; every OTHER failure
    (unreachable coordinator, bad process_id, coordinator_address missing
    outside a recognized cluster env) RE-RAISES.  Fail-fast is the one
    reference virtue worth keeping (utility.h:27-83 exits on every
    backend error): a swallowed bootstrap error would degrade a
    multi-host launch to a silent single-host run whose results look
    valid.  Exercised by tests/test_distributed.py with a real 2-process
    gloo group over the CPU backend."""
    if jax.distributed.is_initialized():
        return
    jax.distributed.initialize(**kwargs)


def replicate(arr, mesh: Mesh) -> jax.Array:
    """Place an array fully replicated over the mesh
    (GpuSharePolicy::replicate, matrix.h:341-356)."""
    return jax.device_put(arr, NamedSharding(mesh, P()))


def shard_along(arr, mesh: Mesh, dim: int, axis: str = DEFAULT_AXIS
                ) -> jax.Array:
    """Place an array split along logical dimension `dim`
    (GpuSharePolicy::segment for dense operands, matrix.h:554-568)."""
    spec = [None] * np.ndim(arr)
    spec[dim] = axis
    return jax.device_put(arr, NamedSharding(mesh, P(*spec)))


def place_dense(arr, mesh: Mesh, policy: SharePolicy, segment_dim: int = 0,
                axis: str = DEFAULT_AXIS) -> jax.Array:
    """Policy-driven placement of a dense operand (the `sync2gpu` analog).

    SEGMENT shards `segment_dim` (the container's `segment_axis` —
    leading-storage-dimension semantics of matrix.h:554-568); REPLICATE and
    NONE replicate (NONE = single-device arrays just pass through jit)."""
    if policy is SharePolicy.SEGMENT:
        require(arr.shape[segment_dim] % mesh.shape[axis] == 0, PartitionError,
                f"dim {segment_dim} size {arr.shape[segment_dim]} not divisible "
                f"by {mesh.shape[axis]} shards; pad first (pad_to_shards)")
        return shard_along(arr, mesh, segment_dim, axis)
    return replicate(arr, mesh)


def pad_to_shards(arr: np.ndarray, n_shards: int, dim: int,
                  multiple_of: int = 1) -> np.ndarray:
    """Zero-pad `dim` so it divides evenly into `n_shards` blocks (each a
    multiple of `multiple_of`).  The reference instead allows ragged last
    shards (matrix.h:563-567); XLA wants equal blocks."""
    size = arr.shape[dim]
    block = -(-(-(-size // n_shards)) // multiple_of) * multiple_of
    target = block * n_shards
    pad = [(0, 0)] * arr.ndim
    pad[dim] = (0, target - size)
    return np.pad(arr, pad) if target != size else arr


def sync_to_host(arr) -> np.ndarray:
    """Gather a (possibly sharded) device array back to host numpy
    (the `sync2cpu` analog, matrix.h:595-612)."""
    return np.asarray(jax.device_get(arr))
