"""Hierarchical two-tier distributed modes over a (slice, chip) mesh.

A multi-host deployment has two interconnect tiers: the device links
within a host (a "slice") and the data-center network (DCN) across hosts
(an order of magnitude less).  A flat mode-2 all-reduce over all n = s*c
devices drags the full result across the slow tier; the hierarchical
variant reduces in two steps so the DCN only ever carries 1/c of the
result:

    partial C (full height, per device)
      -> psum_scatter over the INTRA-SLICE axis   (links: S*(c-1)/c bytes)
      -> psum         over the SLICE axis         (DCN:   2*(S/c)*(s-1)/s)

The result lands row-sharded over the chip axis and replicated across
slices — the layout the next pipeline stage in a multi-host program
wants anyway.  The reference is single-node (README.md:28), so this
feature has no reference analog; a four-card host has no second tier.

Shards come from the SAME row-granular partitioner as the flat planned
modes (`partition_row_plans(A, s*c)`): `shard_map` with
`P((slice_axis, chip_axis))` splits the stacked leading axis over both
mesh axes in row-major order, so shard i runs on (slice i//c, chip i%c).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..utils.errors import PartitionError, ShapeError, require
from .planned import RowPlanShards, _local_spmm, _local_spmv, _unstack

SLICE_AXIS = "slice"
CHIP_AXIS = "chip"


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_mesh2(n_slices: int, chips_per_slice: int,
               slice_axis: str = SLICE_AXIS,
               chip_axis: str = CHIP_AXIS) -> Mesh:
    """(n_slices, chips_per_slice) mesh over the first s*c devices.

    On real hardware the device order from `jax.devices()` groups a
    host's local devices together, so consecutive blocks of
    `chips_per_slice` land intra-slice and the outer axis crosses
    slices (DCN)."""
    devs = jax.devices()
    n = n_slices * chips_per_slice
    require(n <= len(devs), PartitionError,
            f"requested {n} devices ({n_slices}x{chips_per_slice}), "
            f"have {len(devs)}")
    return Mesh(np.array(devs[:n]).reshape(n_slices, chips_per_slice),
                (slice_axis, chip_axis))


@functools.lru_cache(maxsize=None)
def _hier_spmm_program(mesh: Mesh, ax_s: str, ax_c: str, kind: str,
                       m: int, band_rows: int):
    s, c = mesh.shape[ax_s], mesh.shape[ax_c]
    m_full = _round_up(m + band_rows, s * c * 128)

    def fn(shards, B, C, alpha, beta):
        plan = _unstack(shards.plan)
        local = _local_spmm(kind, plan, B)
        partial = jnp.zeros((m_full, B.shape[1]), local.dtype)
        off = shards.row_offsets[0, 0]
        partial = lax.dynamic_update_slice(
            partial, local, (off, jnp.zeros((), off.dtype)))
        # tier 1 (in-host links): reduce-scatter the slice's partial over its chips
        mine = lax.psum_scatter(partial, ax_c, scatter_dimension=0,
                                tiled=True)            # (m_full/c, k)
        # tier 2 (DCN): sum the per-chip row band across slices — 1/c of
        # the result crosses the slow tier instead of all of it
        return beta * C + alpha * lax.psum(mine, ax_s)

    c_spec = P(ax_c, None)  # row-sharded over chips, replicated x slices
    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P((ax_s, ax_c)), P(), c_spec, P(), P()),
        out_specs=c_spec,
        check_vma=True))


@functools.lru_cache(maxsize=None)
def _hier_spmv_program(mesh: Mesh, ax_s: str, ax_c: str, kind: str,
                       m: int, band_rows: int):
    s, c = mesh.shape[ax_s], mesh.shape[ax_c]
    m_full = _round_up(m + band_rows, s * c * 128)

    def fn(shards, x, y, alpha, beta):
        plan = _unstack(shards.plan)
        local = _local_spmv(kind, plan, x)
        partial = jnp.zeros(m_full, local.dtype)
        partial = lax.dynamic_update_slice(
            partial, local, (shards.row_offsets[0, 0],))
        mine = lax.psum_scatter(partial, ax_c, tiled=True)
        return beta * y + alpha * lax.psum(mine, ax_s)

    y_spec = P(ax_c)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P((ax_s, ax_c)), P(), y_spec, P(), P()),
        out_specs=y_spec,
        check_vma=True))


def _check(shards: RowPlanShards, mesh: Mesh, ax_s: str, ax_c: str):
    s, c = mesh.shape[ax_s], mesh.shape[ax_c]
    require(shards.n_shards == s * c, PartitionError,
            f"shards built for {shards.n_shards} devices, mesh is "
            f"{s}x{c}")
    return s, c


def spmm_mode2_hier(shards: RowPlanShards, B, alpha, beta, C, mesh: Mesh,
                    slice_axis: str = SLICE_AXIS,
                    chip_axis: str = CHIP_AXIS) -> jax.Array:
    """Two-tier mode 2 (partition sparse A) over a (slice, chip) mesh:
    reduce-scatter within the slice, DCN psum across slices."""
    s, c = _check(shards, mesh, slice_axis, chip_axis)
    require(B.shape[0] == shards.shape[1], ShapeError,
            f"A width {shards.shape[1]} != B height {B.shape[0]}")
    m = shards.shape[0]
    m_full = _round_up(m + shards.band_rows, s * c * 128)
    prog = _hier_spmm_program(mesh, slice_axis, chip_axis, shards.kind,
                              m, shards.band_rows)
    C_p = jnp.pad(C, ((0, m_full - m), (0, 0)))
    return prog(shards, B, C_p, alpha, beta)[:m]


def spmv_dist_hier(shards: RowPlanShards, x, alpha, beta, y, mesh: Mesh,
                   slice_axis: str = SLICE_AXIS,
                   chip_axis: str = CHIP_AXIS) -> jax.Array:
    """Two-tier distributed SpMV (partition sparse A) — see
    spmm_mode2_hier."""
    s, c = _check(shards, mesh, slice_axis, chip_axis)
    require(x.shape[0] == shards.shape[1], ShapeError,
            f"A width {shards.shape[1]} != x length {x.shape[0]}")
    m = shards.shape[0]
    m_full = _round_up(m + shards.band_rows, s * c * 128)
    prog = _hier_spmv_program(mesh, slice_axis, chip_axis, shards.kind,
                              m, shards.band_rows)
    return prog(shards, x, jnp.pad(y, (0, m_full - m)), alpha, beta)[:m]
