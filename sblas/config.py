"""Global configuration for the sparse-BLAS framework.

Re-design of the reference's compile-time macro config (reference:
config.h:18-27 — ERROR_CHECK, ERROR_BAR 1e-3, RAND_INIT_SEED 211,
WARP_SIZE 32, NUM_THREADS_PER_BLK 256).  Instead of preprocessor macros we
use one frozen dataclass; instead of CUDA launch geometry (XLA owns that)
we carry the layouts' tile sizes.
"""

from __future__ import annotations

import dataclasses
import os

# ---------------------------------------------------------------------------
# Layout tile sizes (padding granules of the plan layouts), not knobs.
# ---------------------------------------------------------------------------
LANES = 128          # minor tile width of the padded layouts
ROW_TILE = 8         # rows per nnz tile (nnz_tile = ROW_TILE * LANES)
BLOCK_DIM = 128      # BELL block edge


@dataclasses.dataclass(frozen=True)
class SBlasConfig:
    """Runtime configuration.

    Mirrors the knobs of the reference's config.h but as data, overridable
    per-call and from the environment (SBLAS_* variables), instead of
    compile-time macros.
    """

    # Verification tolerance.  The reference checks |x - y| <= 1e-3
    # elementwise (utility.h:182-193, config.h:21 `ERROR_BAR`).
    error_bar: float = 1e-3

    # RNG seed for random dense fills (config.h:23 `RAND_INIT_SEED 211`).
    # We keep the value for provenance; the stream itself is numpy/JAX, not
    # C `rand()`, so values differ from the reference (documented deviation).
    rand_seed: int = 211

    # Whether expensive shape/consistency checks run inside host-side code
    # (analog of config.h:19 `ERROR_CHECK`).
    error_check: bool = True

    # Default nnz padding granule for the COO-family layouts.
    nnz_tile: int = ROW_TILE * LANES

    # Default dense tile edge for blocked SpMM paths.
    dense_tile: int = BLOCK_DIM

    # ELL fallback guard: if max_row_nnz > ell_blowup_limit * mean_row_nnz the
    # ELL layout is considered pathological and COO/segment-sum is used.
    ell_blowup_limit: float = 16.0

    # Block-sparse guard: BELL is chosen when stored/true nnz stays under
    # this (dense block matmuls win by more than this factor when it fits).
    bsr_blowup_limit: float = 16.0

    # Block geometry for the BELL layout.
    bsr_block: tuple = (BLOCK_DIM, BLOCK_DIM)

    # Diagonal (DIA) guard for SpMV planning: occupied-diagonal count cap
    # (the per-diagonal slice loop unrolls at trace time) and storage
    # blowup cap (n_diags * m / nnz).
    dia_max_diags: int = 512
    dia_blowup_limit: float = 3.0

    # Hub-column peel threshold for the routed engine: columns with at
    # least this many nonzeros bypass the slab-bucket gather (their
    # entries fill whole 128-lane rows that broadcast one x value — a
    # row-granular gather, 128x cheaper per element than slab slots they
    # would otherwise blow up).  Web-scale in-degree skew makes this
    # mandatory: without it one 40k-in-degree hub inflates the gather
    # tiling ~16x.  Values < 1 disable peeling.
    routed_peel_threshold: int = 128

    # Balanced column relabel for the routed engine's slab-bucket gather.
    # The relabel buys near-uniform bucket loads at the cost of one extra
    # x-route per call (~19 us at shard scale, where per-pass launch
    # overhead dominates).  With hub peeling on, residual in-degrees are
    # < routed_peel_threshold, so small/sharded plans often win by
    # skipping it; the distributed planners measure-or-model the choice.
    routed_relabel: bool = True

    # Hot-set demand threshold for the xfoot exchange (parallel/xfoot.py):
    # columns demanded by >= this many remote shards ride the hot
    # broadcast; the rest go point-to-point.  <= 0 (default) uses the
    # structural optimum 2.  Raising it LOOKS attractive on raw bytes
    # (webbase n=16: q>=4 models 777 -> 516 KB/chip because low-q hot
    # columns ride existing all_to_all pad slack) but is a measured net
    # loss: q-in-[2,qmin) columns then appear in multiple packets, the
    # extraction map stops being a bijection, and the routed engine
    # (Clos = permutations, no multicast) cannot express it — the knob
    # stays for small-footprint experiments only (duplicates force the
    # flat engine).
    xfoot_hot_qmin: int = 0

    # Route-transport precision for the routed SpMV engine: "f32" (default)
    # routes contributions at the value dtype; "bf16" stores the gathered
    # contributions as bfloat16 for the main route's HBM-bound passes and
    # upcasts at the lane-stack reduce.  The route moves every nonzero
    # through ~2*log128(N)-1 read+write passes, so halving the element
    # width halves the dominant traffic of the permutation stage.  Opt-in
    # reduced precision: each contribution gains a <= 2^-9 relative
    # rounding (rows of similar-magnitude terms average to ~1e-4, but the
    # worst case exceeds the reference's 1e-3 bar) — only valid with
    # float32 values.
    routed_transport: str = "f32"

    # Lane-stack depth cap for the routed engine: a row with more than
    # this many nonzeros is split across ceil(deg/cap) rank slots whose
    # partials merge in one small segment-sum before the unrank route.
    # Without the cap a power-law head row sets its whole 128-lane
    # block's stack depth (measured: a webbase shard stacked 528k slots
    # for 202k nnz and crossed a routable-size cliff into a 1.05M-slot
    # route — 2.6x fill and 2x padding).  Values < 1 disable splitting.
    routed_stack_cap: int = 256

    @staticmethod
    def from_env() -> "SBlasConfig":
        def _f(name: str, default: float) -> float:
            return float(os.environ.get(name, default))

        def _i(name: str, default: int) -> int:
            return int(os.environ.get(name, default))

        return SBlasConfig(
            error_bar=_f("SBLAS_ERROR_BAR", 1e-3),
            rand_seed=_i("SBLAS_RAND_SEED", 211),
            error_check=os.environ.get("SBLAS_ERROR_CHECK", "1") != "0",
            nnz_tile=_i("SBLAS_NNZ_TILE", ROW_TILE * LANES),
            dense_tile=_i("SBLAS_DENSE_TILE", BLOCK_DIM),
            ell_blowup_limit=_f("SBLAS_ELL_BLOWUP_LIMIT", 16.0),
            bsr_blowup_limit=_f("SBLAS_BSR_BLOWUP_LIMIT", 16.0),
            bsr_block=(_i("SBLAS_BSR_BLOCK_R", BLOCK_DIM),
                       _i("SBLAS_BSR_BLOCK_C", BLOCK_DIM)),
            dia_max_diags=_i("SBLAS_DIA_MAX_DIAGS", 512),
            dia_blowup_limit=_f("SBLAS_DIA_BLOWUP_LIMIT", 3.0),
            routed_peel_threshold=_i("SBLAS_ROUTED_PEEL", 128),
            routed_relabel=os.environ.get("SBLAS_ROUTED_RELABEL",
                                          "1") != "0",
            routed_stack_cap=_i("SBLAS_ROUTED_STACK_CAP", 256),
            routed_transport=os.environ.get("SBLAS_ROUTED_TRANSPORT",
                                            "f32"),
            xfoot_hot_qmin=_i("SBLAS_XFOOT_QMIN", 0),
        )


# The library-wide default; call sites may pass their own.
DEFAULT = SBlasConfig.from_env()
