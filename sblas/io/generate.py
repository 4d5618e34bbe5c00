"""Deterministic synthetic sparse-matrix generators.

The reference ships one fixture (ash85.mtx — 85x85 pattern-symmetric, 304
stored entries) and a download script for two SuiteSparse benchmark matrices
(matrices/get_matrices.sh: webbase-1M for SpMV, s3dkq4m2 for SpMM).  This
environment has no network egress, so the framework synthesizes
*structure-matched proxies* instead:

* `pattern_symmetric(...)`  — ash85-class smoke fixture;
* `webbase_like(...)`       — power-law row degrees, scattered columns
                              (webbase-1M is a web graph: 1M rows, ~3.1M nnz);
* `fem_banded_like(...)`    — banded FEM structure (s3dkq4m2: n=90449,
                              ~4.8M nnz, ~2.4k band), the SpMM workload.

All generators are seeded and return `CsrMatrix`/`CooMatrix` directly; the
`matrices/gen_matrices.py` CLI writes them as .mtx for file-path parity with
the reference drivers.
"""

from __future__ import annotations

import numpy as np

from ..containers import CooMatrix, CsrMatrix


def _dedupe(m, n, rows, cols, rng, values=None):
    coo = CooMatrix(rows.astype(np.int64), cols.astype(np.int64),
                    (values if values is not None
                     else rng.random_sample(len(rows))), (m, n))
    return coo.to_csr()


def pattern_symmetric(n: int = 85, nnz_target: int = 304, seed: int = 7
                      ) -> CsrMatrix:
    """ash85-class fixture: symmetric pattern matrix with unit values and a
    full diagonal (values all 1.0, like pattern->1.0 expansion)."""
    rng = np.random.RandomState(seed)
    k = max((nnz_target - n) // 2, 0)
    i = rng.randint(0, n, size=3 * k)
    j = rng.randint(0, n, size=3 * k)
    off = i != j
    i, j = i[off][:k], j[off][:k]
    rows = np.concatenate([np.arange(n), i, j])
    cols = np.concatenate([np.arange(n), j, i])
    vals = np.ones(len(rows), dtype=np.float64)
    csr = _dedupe(n, n, rows, cols, rng, vals)
    # duplicate-summed entries back to 1.0 to stay a pattern matrix
    return CsrMatrix(csr.row_ptr, csr.col_idx,
                     np.ones_like(csr.values), csr.shape)


def webbase_like(n: int = 1_000_000, avg_deg: float = 3.1, seed: int = 211,
                 dtype=np.float64, local_frac: float = 0.6,
                 local_scale: float = 2_000.0) -> CsrMatrix:
    """Web-graph proxy: power-law out-degrees, column targets with strong
    locality plus a Zipf-skewed in-degree tail.

    Matches webbase-1M's aggregate stats (n=1e6, nnz~3.1e6, max row degree
    in the thousands) without the actual data (zero-egress environment).
    Real web graphs are NOT uniform in their column targets: most links point to nearby pages (same site — here a
    two-sided geometric offset around the row id, scale `local_scale`),
    and the rest to globally popular hubs (log-uniform target rank ==
    Zipf(1) in-degree).  Hub columns reach ~1e5 in-degree at defaults —
    the duplicate-column stress the uniform proxy never produced."""
    rng = np.random.RandomState(seed)
    # Zipf-ish degrees clipped to n, scaled to hit avg_deg
    raw = rng.zipf(2.1, size=n).astype(np.int64)
    raw = np.minimum(raw, 5000)
    deg = np.maximum((raw * (avg_deg / raw.mean())).astype(np.int64), 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    ne = len(rows)
    is_local = rng.random_sample(ne) < local_frac
    # local: two-sided geometric offset (site-internal links)
    off = rng.geometric(1.0 / local_scale, size=ne).astype(np.int64)
    off *= rng.randint(0, 2, size=ne) * 2 - 1
    local_cols = np.clip(rows + off, 0, n - 1)
    # global: log-uniform target id == Zipf(1)-distributed in-degree;
    # popular pages are the low ids (they are also link *sources* with
    # high out-degree in real crawls — keeping both on low ids is honest)
    u = rng.random_sample(ne)
    hub_cols = np.minimum(np.exp(u * np.log(n)).astype(np.int64), n - 1)
    cols = np.where(is_local, local_cols, hub_cols)
    vals = rng.random_sample(ne).astype(dtype)
    return _dedupe(n, n, rows, cols, rng, vals)


def fem_banded_like(n: int = 90_449, half_band: int = 36, seed: int = 211,
                    dtype=np.float64) -> CsrMatrix:
    """Dense-banded test matrix: every diagonal in [-half_band, half_band]
    fully occupied (~2*half_band+1 nnz per interior row).

    NOT the s3dkq4m2 proxy (that is `fem_shell_like` — the real matrix has
    a ~2.4k bandwidth with sparse stripe structure inside the band, which a
    73-wide dense band misrepresents).  This generator
    remains the canonical *dense-band* structure for DIA/BELL unit tests."""
    rng = np.random.RandomState(seed)
    offsets = np.arange(-half_band, half_band + 1)
    rows_l, cols_l = [], []
    for off in offsets:
        r = np.arange(max(0, -off), min(n, n - off), dtype=np.int64)
        rows_l.append(r)
        cols_l.append(r + off)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = rng.random_sample(len(rows)).astype(dtype)
    return _dedupe(n, n, rows, cols, rng, vals)


def fem_shell_like(nx: int = 201, ny: int = 75, dof: int = 6,
                   n_target: int = 90_449, seed: int = 211,
                   dtype=np.float64) -> CsrMatrix:
    """s3dkq4m2-structure proxy: FEM stiffness matrix of a cylindrical
    shell meshed with 4-node quadrilaterals (reference SpMM benchmark,
    matrices/get_matrices.sh:4-13; s3dkq4m2 = *s*hell, *3d*, *k*ouhia,
    *q4* elements).

    Construction: an nx x ny structured node grid, circumferentially
    wrapped (i +- 1 mod nx), `dof` unknowns per node; two nodes couple iff
    they share an element (the 3x3 node neighborhood), giving a symmetric
    6x6-block matrix with <= 9*dof nnz per row.  Node ids are ordered
    axial-major, so the seam (i=0 <-> i=nx-1) and the j+-1 couplings put
    the outermost stripes ~(nx+1)*dof away from the diagonal: with the
    defaults the full bandwidth is 2*(nx+1)*dof+1 = 2425 (~2.4k, matching
    the real matrix), the stripes *inside* the band are sparse, and
    n = 90450 truncated to `n_target` = 90449 with nnz ~= 4.8M — the real
    aggregate stats, unlike a 73-wide dense band."""
    rng = np.random.RandomState(seed)
    nodes = nx * ny
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()  # node p = j*nx + i
    p = jj * nx + ii
    rows_l, cols_l, vals_l = [], [], []
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            j2 = jj + dj
            keep = (j2 >= 0) & (j2 < ny)
            i2 = (ii + di) % nx  # circumferential wrap
            q = j2 * nx + i2
            src, dst = p[keep], q[keep]
            # one 6x6 random block per directed node pair; symmetry comes
            # from pairing each (p,q,block) with (q,p,block.T) — we only
            # emit pairs with src <= dst and mirror
            upper = src <= dst
            su, du = src[upper], dst[upper]
            blocks = rng.random_sample((len(su), dof, dof))
            a = np.arange(dof)
            shp = (len(su), dof, dof)
            r_idx = np.broadcast_to(
                su[:, None, None] * dof + a[None, :, None], shp).ravel()
            c_idx = np.broadcast_to(
                du[:, None, None] * dof + a[None, None, :], shp).ravel()
            # mirror: entry (r, c, v) also lands at (c, r, v) — the index
            # arrays already swap the (a, b) block coordinates, so the
            # values ravel identically for both
            rows_l += [r_idx, c_idx]
            cols_l += [c_idx, r_idx]
            vals_l += [blocks.ravel(), blocks.ravel()]
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l).astype(dtype)
    keep = (rows < n_target) & (cols < n_target)
    return _dedupe(n_target, n_target, rows[keep], cols[keep], rng,
                   vals[keep])


def uniform_random(m: int, n: int, nnz_per_row: int, seed: int = 211,
                   dtype=np.float64) -> CsrMatrix:
    """Uniform random CSR with ~nnz_per_row entries per row."""
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(m, dtype=np.int64), nnz_per_row)
    cols = rng.randint(0, n, size=len(rows)).astype(np.int64)
    vals = rng.random_sample(len(rows)).astype(dtype)
    return _dedupe(m, n, rows, cols, rng, vals)


def adversarial_skew(m: int = 4096, n: int = 4096, heavy_rows: int = 4,
                     heavy_nnz: int = 2048, light_nnz: int = 2,
                     seed: int = 13, dtype=np.float64) -> CsrMatrix:
    """Pathologically skewed row distribution — exercises the nnz-balanced
    partitioner's row-straddling path (reference matrix.h:443-445) and the
    ELL blowup guard."""
    rng = np.random.RandomState(seed)
    hr = rng.choice(m, size=heavy_rows, replace=False)
    rows = [np.repeat(np.arange(m, dtype=np.int64), light_nnz),
            np.repeat(hr.astype(np.int64), heavy_nnz)]
    rows = np.concatenate(rows)
    cols = rng.randint(0, n, size=len(rows)).astype(np.int64)
    vals = rng.random_sample(len(rows)).astype(dtype)
    return _dedupe(m, n, rows, cols, rng, vals)


def road_network_like(n: int = 200_000, avg_deg: float = 2.6,
                      scale: float = 40.0, seed: int = 211,
                      dtype=np.float64) -> CsrMatrix:
    """Road-network proxy: uniformly LOW degree (planar graphs average
    2-4 edges per node) with short-range column offsets (nodes connect to
    geometric neighbours) — the SuiteSparse USA-road class.  Unlike
    `webbase_like` there are no hubs and no power-law tail; unlike
    `fem_banded_like` the band is sparse, not dense — the structure class
    where neither DIA (huge blowup) nor hub peeling applies."""
    rng = np.random.RandomState(seed)
    deg = rng.poisson(max(avg_deg - 1.0, 0.0), size=n) + 1
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    ne = len(rows)
    off = rng.geometric(1.0 / scale, size=ne).astype(np.int64)
    off *= rng.randint(0, 2, size=ne) * 2 - 1
    cols = np.clip(rows + off, 0, n - 1)
    vals = rng.random_sample(ne).astype(dtype)
    return _dedupe(n, n, rows, cols, rng, vals)


def block_dominant(n_brows: int = 64, block: int = 128,
                   blocks_per_row: int = 4, inner_fill: float = 0.5,
                   seed: int = 211, dtype=np.float64) -> CsrMatrix:
    """Block-structured matrix: `blocks_per_row` random block-column tiles
    per block-row, each `block x block` tile filled to `inner_fill`
    density — the multiphysics / vector-unknown FEM class where the BELL
    (batched dense block matmul) layout is the right answer.  Defaults give an
    8192x8192 matrix with ~2.1M nnz and a 128x128 BELL blowup of
    ~1/inner_fill."""
    rng = np.random.RandomState(seed)
    n = n_brows * block
    rows_l, cols_l = [], []
    for br in range(n_brows):
        bcs = rng.choice(n_brows, size=min(blocks_per_row, n_brows),
                         replace=False)
        for bc in bcs:
            mask = rng.random_sample((block, block)) < inner_fill
            r, c = np.nonzero(mask)
            rows_l.append(br * block + r.astype(np.int64))
            cols_l.append(bc * block + c.astype(np.int64))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = rng.random_sample(len(rows)).astype(dtype)
    return _dedupe(n, n, rows, cols, rng, vals)


def scattered_sparse(n: int = 500_000, nnz: int = 5_000, seed: int = 211,
                     dtype=np.float64) -> CsrMatrix:
    """Near-empty matrix: `nnz` entries scattered uniformly over an n x n
    space (most rows empty, huge row gaps) — the regime that stresses
    tile-split overhead guards (`_WCOO_FILL_LIMIT`) and empty-row
    handling."""
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, n, size=nnz).astype(np.int64)
    cols = rng.randint(0, n, size=nnz).astype(np.int64)
    vals = rng.random_sample(nnz).astype(dtype)
    return _dedupe(n, n, rows, cols, rng, vals)


def structure_stats(A: CsrMatrix) -> dict:
    """Structural fingerprint of a sparse matrix, for proxy validation.

    The headline numbers ride structure-matched proxies because the real
    SuiteSparse benchmark files are unfetchable here (no egress); this
    fingerprint makes the match CHECKABLE: run it on the real .mtx (via
    matrices/compare_proxy.py) the day one is obtainable and compare
    against the generator's output.  Covers the properties the planners
    key on: degree distribution (layout choice, stack cap), in-degree
    skew (hub peeling), bandwidth/locality (DIA vs routed, halo width).
    """
    m, n = A.shape
    deg = A.row_nnz.astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), deg)
    cols = A.col_idx.astype(np.int64)
    nnz = int(A.nnz)
    indeg = np.bincount(cols, minlength=n) if nnz else np.zeros(n, np.int64)
    d = np.abs(rows - cols) if nnz else np.zeros(0, np.int64)
    qs = [50, 90, 99, 99.9]
    band_fracs = {w: float((d < w).mean()) if nnz else 0.0
                  for w in (64, 2048, 65536)}
    return {
        "shape": (int(m), int(n)),
        "nnz": nnz,
        "avg_deg": nnz / max(m, 1),
        "row_deg_pct": {q: float(np.percentile(deg, q)) if m else 0.0
                        for q in qs},
        "row_deg_max": int(deg.max()) if m else 0,
        "col_indeg_pct": {q: float(np.percentile(indeg, q)) if n else 0.0
                          for q in qs},
        "col_indeg_max": int(indeg.max()) if n else 0,
        "hub_cols_ge128": int((indeg >= 128).sum()),
        "bandwidth_pct": {q: float(np.percentile(d, q)) if nnz else 0.0
                          for q in qs},
        "band_frac": band_fracs,
        "empty_rows_frac": float((deg == 0).mean()) if m else 0.0,
        "sym_pattern_sample": _symmetry_sample(A, rows, cols),
    }


def _symmetry_sample(A: CsrMatrix, rows, cols, k: int = 4096,
                     seed: int = 0):
    """Fraction of a sampled entry set whose transpose position is also
    stored (1.0 = structurally symmetric on the sample); None for
    rectangular matrices, where the notion is undefined (and a column id
    may exceed the row count)."""
    if A.shape[0] != A.shape[1]:
        return None
    nnz = len(rows)
    if nnz == 0:
        return 1.0
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, nnz, size=min(k, nnz))
    hit = 0
    rp, ci = A.row_ptr, A.col_idx
    for e in idx:
        r, c = int(cols[e]), int(rows[e])  # transpose position
        lo, hi = int(rp[r]), int(rp[r + 1])
        hit += int(np.searchsorted(ci[lo:hi], c) < hi - lo
                   and ci[lo + np.searchsorted(ci[lo:hi], c)] == c)
    return hit / len(idx)
