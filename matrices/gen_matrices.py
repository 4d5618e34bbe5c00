#!/usr/bin/env python3
"""Synthesize the benchmark matrix set as .mtx files.

Analog of the reference's matrices/get_matrices.sh (downloads SuiteSparse
webbase-1M and s3dkq4m2); this environment has no network egress, so we
generate structure-matched proxies instead (see sblas/io/generate.py):

    python matrices/gen_matrices.py [--small] [outdir]

Writes webbase-1M-like.mtx (SpMV benchmark) and s3dkq4m2-like.mtx (SpMM
benchmark, K=64 in the canonical invocation).  --small writes reduced sizes
for quick runs.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from sblas.io.generate import fem_shell_like, webbase_like  # noqa: E402
from sblas.io.mmio import write_mtx  # noqa: E402


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    small = "--small" in args
    args = [a for a in args if a != "--small"]
    outdir = args[0] if args else os.path.dirname(__file__) or "."
    os.makedirs(outdir, exist_ok=True)

    jobs = {
        "webbase-1M-like.mtx": webbase_like(n=100_000 if small else 1_000_000),
        "s3dkq4m2-like.mtx": (fem_shell_like(nx=51, ny=25, dof=6,
                                             n_target=51 * 25 * 6 - 1)
                              if small else fem_shell_like()),
    }
    for name, csr in jobs.items():
        path = os.path.join(outdir, name)
        coo = csr.to_coo()
        print(f"writing {path}: {csr.shape} nnz={csr.nnz}")
        write_mtx(path, *csr.shape, coo.row_idx, coo.col_idx, coo.values,
                  comment="synthetic proxy generated by sblas "
                          "(zero-egress environment)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
