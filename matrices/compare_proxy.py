#!/usr/bin/env python3
"""Compare a real .mtx against its structure-matched proxy generator.

The benchmark numbers ride synthetic proxies (sblas/io/generate.py)
because the reference's SuiteSparse workloads are unfetchable here
(reference matrices/get_matrices.sh:4-13; no network egress).  This tool
makes the proxy argument CHECKABLE: point it at the real file the day one
is obtainable and it prints the structural fingerprint side by side with
the generator's — degree distribution, in-degree skew, bandwidth
profile, symmetry — i.e. exactly the properties the planners key on.

    python matrices/compare_proxy.py webbase-1M.mtx webbase
    python matrices/compare_proxy.py s3dkq4m2.mtx shell
    python matrices/compare_proxy.py any.mtx          # stats only
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _fmt(v):
    if v is None:
        return "n/a"
    if isinstance(v, float):
        return f"{v:.4g}"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{k}: {_fmt(x)}" for k, x in v.items()) + "}"
    return str(v)


def main(argv) -> int:
    from sblas.containers import CsrMatrix
    from sblas.io.generate import (fem_shell_like, structure_stats,
                                       webbase_like)

    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    real = structure_stats(CsrMatrix.from_mtx(argv[0], dtype=np.float32))
    proxy = None
    if len(argv) > 1:
        gen = {"webbase": lambda: webbase_like(dtype=np.float32),
               "shell": lambda: fem_shell_like(dtype=np.float32)}.get(argv[1])
        if gen is None:
            print(f"unknown proxy {argv[1]!r} (webbase|shell)",
                  file=sys.stderr)
            return 2
        proxy = structure_stats(gen())
    keys = list(real)
    wid = max(len(k) for k in keys)
    header = f"{'stat':<{wid}}  {'real':<40}" + ("proxy" if proxy else "")
    print(header)
    for k in keys:
        line = f"{k:<{wid}}  {_fmt(real[k]):<40}"
        if proxy:
            line += _fmt(proxy[k])
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
