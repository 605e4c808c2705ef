"""The Fortran 2003 interface module of the port's driver C API.

The counterpart of the reference's tools/generate_fortran.py (itself the
analog of SLATE's tools/fortran/generate_fortran_module.py): the routine
table is declared here and :func:`emit` writes iso_c_binding interfaces
that match native/slate_tpu_torch_capi.h exactly.  The committed output
is slate_tpu_torch/native/slate_tpu_torch.f90; regenerate it from the
repo root with

    python -m slate_tpu_torch.compat.fortran > \\
        slate_tpu_torch/native/slate_tpu_torch.f90
"""

from __future__ import annotations

_I64 = "integer(c_int64_t)"
_F64 = "real(c_double)"


def _args(*spec):
    """(fortran_name, c_type, intent, is_array) from compact specs: a name
    alone is an int64 value; "*name" a double array read, "&name" a
    double array written."""
    out = []
    for s in spec:
        if s[0] == "*":
            out.append((s[1:], _F64, "in", True))
        elif s[0] == "&":
            out.append((s[1:], _F64, "inout", True))
        else:
            out.append((s, _I64, "in", False))
    return out


# (name, [(fortran_name, c_type, intent, is_array), ...], comment)
ROUTINES = [
    ("slate_tpu_torch_dgesv",
     _args("n", "nrhs", "*a", "lda", "*b", "ldb", "&x", "ldx", "nb"),
     "Solve A X = B by partially-pivoted LU."),
    ("slate_tpu_torch_dposv",
     _args("n", "nrhs", "*a", "lda", "*b", "ldb", "&x", "ldx", "nb"),
     "Solve A X = B, A Hermitian positive definite."),
    ("slate_tpu_torch_dgels",
     _args("m", "n", "nrhs", "*a", "lda", "*b", "ldb", "&x", "ldx", "nb"),
     "Least squares min ||A X - B||."),
    ("slate_tpu_torch_dsyev",
     _args("n", "*a", "lda", "&w", "nb"),
     "Eigenvalues (ascending) of symmetric A."),
    ("slate_tpu_torch_dgesvd",
     _args("m", "n", "*a", "lda", "&s", "nb"),
     "Singular values (descending) of A."),
]


def emit() -> str:
    lines = [
        "! Generated by slate_tpu_torch/compat/fortran.py; do not edit.",
        "! Fortran interfaces to the slate_tpu_torch driver C API",
        "! (slate_tpu_torch/native/slate_tpu_torch_capi.h).  Buffers are",
        "! ROW-major with row stride ld*: pass transposed data or",
        "! row-major arrays.",
        "module slate_tpu_torch",
        "  use iso_c_binding",
        "  implicit none",
        "  interface",
        "",
        "    integer(c_int) function slate_tpu_torch_init() &",
        "        bind(c, name='slate_tpu_torch_init')",
        "      use iso_c_binding",
        "    end function slate_tpu_torch_init",
        "",
        "    subroutine slate_tpu_torch_finalize() &",
        "        bind(c, name='slate_tpu_torch_finalize')",
        "    end subroutine slate_tpu_torch_finalize",
        "",
    ]
    for name, args, comment in ROUTINES:
        argnames = ", ".join(a[0] for a in args)
        lines.append(f"    ! {comment}")
        lines.append(f"    integer(c_int) function {name}( &")
        lines.append(f"        {argnames}) &")
        lines.append(f"        bind(c, name='{name}')")
        lines.append("      use iso_c_binding")
        for an, ct, intent, arr in args:
            dim = ", dimension(*)" if arr else ", value"
            lines.append(f"      {ct}{dim}, intent({intent}) :: {an}")
        lines.append(f"    end function {name}")
        lines.append("")
    lines += ["  end interface", "end module slate_tpu_torch", ""]
    return "\n".join(lines)


if __name__ == "__main__":
    print(emit(), end="")
