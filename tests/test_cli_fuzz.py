"""CLI-surface differential fuzz.

The reference's drivers ARE its integration tests (SURVEY §4); the
targeted CLI tests cover happy paths and selected errors but not the
combinatorial Matrix-Market surface.  Here: random small .mtx files
across the legal {format x field x symmetry} combinations, written BY
HAND (not via `write_mtx` — the point is to fuzz the parse surface with
files the writer would never produce), pushed through all five drivers
with mode/method/plan-cache variations, asserting exit code 0 and
`Validation = True` everywhere.  The drivers self-verify against the
CPU oracle (reference README.md:79), so a pass means the whole
parse -> plan -> distribute -> compute -> verify chain agreed.
"""

import numpy as np
import pytest

# legal MM header combinations (mmio.h:36-51 typecode rules): pattern is
# coordinate-only, hermitian is complex-only, skew excludes pattern
COMBOS = [
    ("coordinate", "real", "general"),
    ("coordinate", "real", "symmetric"),
    ("coordinate", "real", "skew-symmetric"),
    ("coordinate", "integer", "general"),
    ("coordinate", "integer", "symmetric"),
    ("coordinate", "pattern", "general"),
    ("coordinate", "pattern", "symmetric"),
    ("coordinate", "complex", "general"),
    ("coordinate", "complex", "hermitian"),
    ("array", "real", "general"),
    ("array", "real", "symmetric"),
    ("array", "real", "skew-symmetric"),
    ("array", "integer", "general"),
    ("array", "complex", "symmetric"),
]


def _write_mm(path, rng, fmt, field, symm):
    square = symm != "general" or bool(rng.integers(0, 2))
    m = int(rng.integers(8, 40))
    n = m if square else int(rng.integers(8, 40))

    def val():
        if field == "integer":
            return str(int(rng.integers(1, 9)))
        if field == "complex":
            return f"{rng.normal():.4f} {rng.normal():.4f}"
        return f"{rng.normal():.4f}"

    lines = [f"%%MatrixMarket matrix {fmt} {field} {symm}",
             "% fuzz fixture"]
    if fmt == "array":
        lines.append(f"{m} {n}")
        for j in range(n):  # column-major stream (MM spec)
            if symm in ("symmetric", "hermitian"):
                i0 = j
            elif symm == "skew-symmetric":
                i0 = j + 1
            else:
                i0 = 0
            for _i in range(i0, m):
                lines.append(val())
    else:
        ents = set()
        while len(ents) < 4:
            for _ in range(int(rng.integers(8, 2 * m))):
                i = int(rng.integers(0, m))
                j = int(rng.integers(0, n))
                if symm != "general" and j > i:
                    i, j = j, i
                if symm == "skew-symmetric" and i == j:
                    continue
                ents.add((i, j))
        lines.append(f"{m} {n} {len(ents)}")
        for (i, j) in sorted(ents):
            pos = f"{i + 1} {j + 1}"
            lines.append(pos if field == "pattern" else f"{pos} {val()}")
    path.write_text("\n".join(lines) + "\n")
    return m, n


@pytest.mark.parametrize("fmt,field,symm", COMBOS)
def test_cli_surface(fmt, field, symm, tmp_path, capsys):
    rng = np.random.default_rng(abs(hash((fmt, field, symm))) % 2**31)
    path = tmp_path / "fuzz.mtx"
    _write_mm(path, rng, fmt, field, symm)

    from sblas.cli.spmm_test import main as spmm_main
    from sblas.cli.spmm_test_um import main as spmm_um_main
    from sblas.cli.spmv_test import main as spmv_main
    from sblas.cli.spmv_test_um import main as spmv_um_main
    from sblas.cli.unit_test import main as unit_main

    cache = str(tmp_path / "plan.npz")
    runs = [
        ("spmv single", spmv_main,
         [str(path), "3.0", "4.0", "1", "f64", "--mode", "single"]),
        ("spmv single cached-cold", spmv_main,
         [str(path), "3.0", "4.0", "1", "f64", "--mode", "single",
          "--plan-cache", cache]),
        ("spmv single cached-warm", spmv_main,
         [str(path), "3.0", "4.0", "1", "f64", "--mode", "single",
          "--plan-cache", cache]),
        ("spmv dist", spmv_main,
         [str(path), "3.0", "4.0", "4", "f64", "--mode", "dist"]),
        ("spmm 1", spmm_main,
         ["1", str(path), "8", "3.0", "4.0", "4", "f64"]),
        ("spmm 2", spmm_main,
         ["2", str(path), "8", "3.0", "4.0", "4", "f64"]),
        ("spmv_um", spmv_um_main,
         [str(path), "3.0", "4.0", "2", "1", "f64"]),
        ("spmm_um", spmm_um_main,
         ["2", str(path), "8", "3.0", "4.0", "2", "1", "f64"]),
        ("unit_test", unit_main, [str(path)]),
    ]
    for name, fn, argv in runs:
        rc = fn(argv)
        out = capsys.readouterr().out
        assert rc == 0, f"[{fmt}/{field}/{symm}] {name} rc={rc}\n{out}"
        assert "Validation = True" in out, (
            f"[{fmt}/{field}/{symm}] {name}\n{out}")
        assert "Validation = False" not in out, (
            f"[{fmt}/{field}/{symm}] {name}\n{out}")
