"""Inputs and per-rank bodies of the distributed tests of slate_tpu_torch.

Imported by the test modules (which compute the reference's results with
``slate_tpu`` in the parent) and by the spawned gloo ranks (which run the
port), so it imports no JAX.  Every input comes from numpy generators
with fixed seeds, the same in the parent and in every rank.  A rank body
returns plain numpy data (rank 0's whole results, and per-rank local
tiles where a test needs them) so that the parent can compare.
"""

from __future__ import annotations

import numpy as np

NB = 4
N = 23            # ragged: 23 = 5*4 + 3
K = 18
NRHS = 7
GRIDS = [(1, 1), (2, 2), (2, 4), (4, 2)]
TOL = {"float32": 1e-4, "float64": 1e-12, "complex128": 1e-12}


def _rng_matrix(rng, dtype, *shape):
    x = rng.standard_normal(shape)
    if dtype.startswith("complex"):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def inputs(dtype: str, seed: int = 0) -> dict:
    """The operands of every case, numpy, in ``dtype``."""
    rng = np.random.default_rng(seed)
    a = _rng_matrix(rng, dtype, N, K)
    b = _rng_matrix(rng, dtype, K, NRHS)
    c = _rng_matrix(rng, dtype, N, NRHS)
    sq = _rng_matrix(rng, dtype, N, N)
    bk = _rng_matrix(rng, dtype, N, K)
    rhs = _rng_matrix(rng, dtype, N, NRHS)
    rhs_r = _rng_matrix(rng, dtype, NRHS, N)
    h = _rng_matrix(rng, dtype, N, N)
    eye = np.eye(N, dtype=dtype)
    return {
        "a": a, "b": b, "c": c, "bk": bk, "rhs": rhs, "rhs_r": rhs_r,
        "spd": (sq @ sq.conj().T + N * eye).astype(dtype),
        "tri": (np.tril(sq) + N * eye).astype(dtype),
        "herm": ((h + h.conj().T) / 2).astype(dtype),
        "sq": sq,
    }


# ---------------------------------------------------------------- cases
#
# Each case is (name, dtype, call): ``call(st, M, x, opts)`` returns the
# dense result, given the package ``st``, a constructor ``M(array, kind,
# uplo)`` of matrices on the case's grid, the inputs ``x`` and the mesh
# options.  The same call runs in the parent on slate_tpu (the reference)
# and in every rank on slate_tpu_torch.

def _tri(st, M, x, uplo, diag="n"):
    arr = x["tri"] if uplo == "l" else x["tri"].T.conj().copy()
    U = st.Uplo.Lower if uplo == "l" else st.Uplo.Upper
    D = st.Diag.Unit if diag == "u" else st.Diag.NonUnit
    return M(arr, "tri", U, D)


def _op(T, op):
    return {"n": T, "t": T.transpose(), "c": T.conj_transpose()}[op]


def _case_trsm(side, uplo, op, diag="n"):
    def call(st, M, x, o):
        T = _op(_tri(st, M, x, uplo, diag), op)
        B = M(x["rhs"] if side == "l" else x["rhs_r"])
        return st.trsm(side, 2.0, T, B, o)
    return call


def _case_trmm(side, uplo):
    def call(st, M, x, o):
        T = _tri(st, M, x, uplo)
        B = M(x["rhs"] if side == "l" else x["rhs_r"])
        return st.trmm(side, 2.0, T, B, o)
    return call


def _case_rank_k(which, uplo):
    def call(st, M, x, o):
        U = st.Uplo.Lower if uplo == "l" else st.Uplo.Upper
        kind = "herm" if which in ("herk", "her2k") else "sym"
        C = M(x["herm"], kind, U)
        if which in ("herk", "syrk"):
            out = getattr(st, which)(0.5, M(x["a"]), 2.0, C, o)
        else:
            out = getattr(st, which)(0.5, M(x["a"]), M(x["bk"]), 2.0, C, o)
        return out
    return call


def _gemm(method=None, abft=False):
    def call(st, M, x, o):
        o = dict(o)
        if method:
            o[st.Option.MethodGemm] = getattr(st.MethodGemm, method)
        if abft:
            o[st.Option.Abft] = st.options.Abft.On
        return st.gemm(1.5, M(x["a"]), M(x["b"]), 0.5, M(x["c"]), o)
    return call


def _hemm(side):
    def call(st, M, x, o):
        A = M(x["herm"], "herm", st.Uplo.Lower)
        if side == "l":
            return st.hemm("l", 1.5, A, M(x["rhs"]), 0.5, M(x["rhs"]), o)
        return st.hemm("r", 1.5, A, M(x["rhs_r"]), 0.5, M(x["rhs_r"]), o)
    return call


def _potrf(uplo):
    def call(st, M, x, o):
        if uplo == "l":
            A = M(x["spd"], "herm", st.Uplo.Lower)
        else:
            A = M(x["spd"].conj().T.copy(), "herm", st.Uplo.Upper)
        return st.potrf(A, o)
    return call


def _potrf_36(st, M, x, o):
    """potrf at n = 36 in 8 x 8 tiles (Nt = 5: every grid ragged in tile
    count), A = G G^T + 36 I from seed 36."""
    rng = np.random.default_rng(36)
    gg = rng.standard_normal((36, 36))
    return st.potrf(M(gg @ gg.T + 36 * np.eye(36), "herm", st.Uplo.Lower,
                      nb=8), o)


def _posv(st, M, x, o):
    return st.posv(M(x["spd"], "herm", st.Uplo.Lower), M(x["rhs"]), o)[1]


def _trtri(st, M, x, o):
    return st.trtri(_tri(st, M, x, "l"), o)


BLAS3_CASES = [
    ("gemm_summa", "float64", _gemm()),
    ("gemm_summa", "float32", _gemm()),
    ("gemm_summa", "complex128", _gemm()),
    ("gemmA", "float64", _gemm("gemmA")),
    ("gemm_abft", "float64", _gemm(abft=True)),
    ("hemm_left", "complex128", _hemm("l")),
    ("hemm_right", "float64", _hemm("r")),
    ("trsm_lln", "float64", _case_trsm("l", "l", "n")),
    ("trsm_lln", "float32", _case_trsm("l", "l", "n")),
    ("trsm_lut", "float64", _case_trsm("l", "u", "t")),
    ("trsm_rlt", "float64", _case_trsm("r", "l", "t")),
    ("trsm_run", "float64", _case_trsm("r", "u", "n")),
    ("trsm_llc", "complex128", _case_trsm("l", "l", "c")),
    ("trsm_ruc", "complex128", _case_trsm("r", "u", "c")),
    ("trsm_lln_unit", "float64", _case_trsm("l", "l", "n", "u")),
    ("trmm_ll", "float64", _case_trmm("l", "l")),
    ("trmm_ru", "float64", _case_trmm("r", "u")),
    ("herk_l", "complex128", _case_rank_k("herk", "l")),
    ("syrk_u", "float64", _case_rank_k("syrk", "u")),
    ("her2k_u", "complex128", _case_rank_k("her2k", "u")),
    ("syr2k_l", "float64", _case_rank_k("syr2k", "l")),
]

CHOL_CASES = [
    ("potrf_lower", "float64", _potrf("l")),
    ("potrf_lower", "float32", _potrf("l")),
    ("potrf_upper", "complex128", _potrf("u")),
    ("posv", "float64", _posv),
    ("posv", "float32", _posv),
    ("potrf_n36_nb8", "float64", _potrf_36),
    ("trtri", "float64", _trtri),
]


# the reference's checksum SUMMA (summa.py abft=True) does not trace under
# the installed JAX: its fori_loop carry's checksums lack the mesh axes'
# varying type (a TypeError the reference's own @slow tests would meet),
# so gemm under Abft is held to the reference's plain SUMMA, the product
# its silent repair leaves when nothing strikes
REF_CALL = {"gemm_abft": _gemm()}


def ref_dtype(dt: str) -> str:
    """The dtype the reference runs a case in: an f32 case is held to the
    reference's f64 result of the same inputs (within the f32 tolerance),
    so that the reference compiles each case once."""
    return "float64" if dt == "float32" else dt


def mesh_grid(st, p: int, q: int):
    """A p x q grid over this world's default group, on the CPU (a 1 x 1
    grid too: a real one-rank mesh, not the serial grid)."""
    import torch.distributed as dist
    return st.Grid(p, q, group=dist.group.WORLD, device="cpu")


def case_id(case) -> str:
    return f"{case[0]}-{case[1]}"


def matrix_maker(st, grid, **kw):
    """``M(array, kind="ge", uplo=None, diag=None, nb=NB)`` on ``grid``."""
    def M(arr, kind="ge", uplo=None, diag=None, nb=NB):
        if kind == "tri":
            return st.TriangularMatrix.from_numpy(arr, nb, uplo, diag,
                                                  grid=grid, **kw)
        if kind == "herm":
            return st.HermitianMatrix.from_numpy(arr, nb, uplo, grid=grid,
                                                 **kw)
        if kind == "sym":
            return st.SymmetricMatrix.from_numpy(arr, nb, uplo, grid=grid,
                                                 **kw)
        return st.Matrix.from_numpy(arr, nb, nb, grid=grid, **kw)
    return M


def dense(X) -> np.ndarray:
    """A driver's result as the dense numpy array its view reads."""
    return np.asarray(X.to_numpy() if hasattr(X, "to_numpy")
                      else X.to_dense())


# ------------------------------------------------------------ rank bodies

def run_cases(p: int, q: int, which: str) -> dict:
    """Every case of ``which`` ("blas3" or "chol") on a p x q grid of this
    world's ranks, with Target.mesh: {case id: dense result}, the same
    on every rank."""
    import slate_tpu_torch as st
    g = mesh_grid(st, p, q)
    M = matrix_maker(st, g)
    o = {st.Option.Target: st.Target.mesh}
    out = {}
    for case in (BLAS3_CASES if which == "blas3" else CHOL_CASES):
        _, dt, call = case
        out[case_id(case)] = dense(call(st, M, inputs(dt), o))
    return out


# ---- the storage layout, the collectives, norm, redistribute ----

LAYOUT_DTYPES = ("float32", "float64", "complex128")


def core_body(p: int, q: int) -> dict:
    """This rank's local tiles of ``inputs(dt)["a"]`` per dtype, the
    collectives' results, the norms and a round trip through
    ``redistribute`` onto the transposed grid."""
    import torch
    import slate_tpu_torch as st
    from slate_tpu_torch.comm import collectives as cc
    from slate_tpu_torch.types import Norm
    g = mesh_grid(st, p, q)
    r, c = g.coords
    out = {"coords": (r, c)}
    for dt in LAYOUT_DTYPES:
        A = st.Matrix.from_numpy(inputs(dt)["a"], NB, NB, grid=g)
        out[f"local_{dt}"] = A.storage.data.numpy().copy()
        out[f"dense_{dt}"] = dense(A)
    x = torch.full((2, 3), complex(10 * r + c, -1), dtype=torch.complex128)
    out["bcast_q"] = cc.bcast_along(x, q - 1, "q", g)[0, 0].item()
    out["bcast_p"] = cc.bcast_along(x, p - 1, "p", g)[0, 0].item()
    out["ring_q"] = cc.ring_bcast_along(x, q // 2, "q", g).wait()[0, 0].item()
    out["ring_p"] = cc.ring_bcast_along(x, p // 2, "p", g).wait()[0, 0].item()
    # two rings in flight in one group, the later root's send first
    h1 = cc.ring_bcast_along(x, 0, "q", g)
    h2 = cc.ring_bcast_along(x + 100, q - 1, "q", g)
    out["ring_pair"] = (h1.wait()[0, 0].item(), h2.wait()[0, 0].item())
    cc.flush(g)
    out["reduce_p"] = cc.reduce_along(x, "p", g)[0, 0].item()
    out["reduce_grid_max"] = cc.reduce_grid(torch.tensor(float(r * q + c)),
                                            g, op="max").item()
    out["allgather_q"] = cc.allgather_along(
        torch.tensor([float(c)]), "q", g).tolist()
    out["reduce_scatter_q"] = cc.reduce_scatter_along(
        torch.arange(2.0 * q, dtype=torch.float64) + c, "q", g).tolist()
    # MAXLOC with a tie: every member offers |v| = 5 but the lowest index
    # wins; then a strict maximum on the last member
    out["pargmax_tie"] = [t.item() for t in cc.pargmax(
        torch.tensor(5.0), torch.tensor(7 - r), "p", g)]
    out["pargmax"] = [t.item() for t in cc.pargmax(
        torch.tensor(float(r)), torch.tensor(10 + r), "p", g)]
    out["shift_q"] = cc.ppermute_shift(torch.tensor([float(c)]), "q", 1,
                                       g).item()
    x64 = inputs("float64")
    norms = {}
    mats = {"ge": st.Matrix.from_numpy(x64["a"], NB, NB, grid=g),
            "he": st.HermitianMatrix.from_numpy(x64["herm"], NB,
                                                st.Uplo.Upper, grid=g),
            "tr": st.TriangularMatrix.from_numpy(x64["tri"], NB,
                                                 st.Uplo.Lower,
                                                 st.Diag.Unit, grid=g)}
    for kind, A in mats.items():
        for nt in ("Max", "One", "Inf", "Fro"):
            norms[f"{kind}_{nt}"] = float(st.norm(getattr(Norm, nt), A))
    norms["col_norms"] = st.col_norms(mats["ge"]).numpy()
    out["norms"] = norms
    g2 = mesh_grid(st, q, p)
    R = st.redistribute(mats["ge"], grid=g2)
    out["redistribute_local"] = R.storage.data.numpy().copy()
    out["redistribute_want"] = st.Matrix.from_numpy(
        x64["a"], NB, NB, grid=g2).storage.data.numpy().copy()
    out["redistribute_back"] = dense(st.redistribute(R, grid=g))
    out["redistribute_nb"] = dense(st.redistribute(mats["ge"], 5, 3))
    return out


def blas3_body(p: int, q: int) -> dict:
    out = {"cases": run_cases(p, q, "blas3")}
    out.update(summa_depths(p, q))
    return out


def summa_depths(p: int, q: int) -> dict:
    """SUMMA at lookahead depths 0, 1 and 2, with and without ABFT, and
    with a post_collective strike under ABFT (the reference's
    test_lookahead.py:268-299 shapes): per depth, the local result and
    the counters."""
    import slate_tpu_torch as st
    from slate_tpu_torch.parallel.summa import summa_gemm_data
    from slate_tpu_torch.robust import faults
    g = mesh_grid(st, p, q)
    out = {}
    for dt in ("float32", "float64"):
        A, B, C = summa_operands(st, g, dt)
        Kt = A.storage.Nt
        for abft in (False, True):
            runs = []
            for la in (0, 1, 2):
                res = summa_gemm_data(A.storage.data, B.storage.data,
                                      C.storage.data, 1.5, 0.5, Kt, g,
                                      abft=abft, la=la)
                res = res if abft else (res,)
                runs.append([x.numpy().copy() for x in res])
            out[f"summa_{dt}_{abft}"] = runs
        plan = faults.FaultPlan("post_collective", kind="bitflip", seed=3,
                                tile=(1, 0))
        runs = []
        with faults.inject(plan):
            for la in (0, 1, 2):
                res = summa_gemm_data(A.storage.data, B.storage.data,
                                      C.storage.data, 1.5, 0.5, Kt, g,
                                      abft=True, la=la)
                runs.append([x.numpy().copy() for x in res])
        out[f"summa_strike_{dt}"] = runs
    return out


def summa_operands(st, grid, dt, **kw):
    """A [18 x 22], B [22 x 14], C zero, in NB tiles (the reference's
    test_lookahead.py _summa_args), from seed 42."""
    rng = np.random.default_rng(42)
    a = rng.standard_normal((18, 22)).astype(dt)
    b = rng.standard_normal((22, 14)).astype(dt)
    return (st.Matrix.from_numpy(a, NB, NB, grid=grid, **kw),
            st.Matrix.from_numpy(b, NB, NB, grid=grid, **kw),
            st.Matrix.from_numpy(np.zeros((18, 14), dt), NB, NB, grid=grid,
                                 **kw))


def chol_storage_array(dt, n=13, seed=42):
    """The reference's test_lookahead.py _chol_storage matrix: B B^T + n I
    from ``seed``."""
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((n, n))
    return (b @ b.T + n * np.eye(n)).astype(dt)


# planted strikes on dist_potrf (the reference's test_lookahead.py:302-323
# and a post_panel strike whose seed lands below the diagonal of the 4 x 4
# diagonal factor)
CHOL_STRIKES = {"post_collective": dict(kind="bitflip", seed=3, tile=(1, 0)),
                "post_panel": dict(kind="bitflip", seed=0)}


def indefinite() -> np.ndarray:
    """``inputs("float64")["spd"]`` with A[9, 9] = -1: the first leading
    minor that is not positive definite is the 10th."""
    a = inputs("float64")["spd"].copy()
    a[9, 9] = -1.0
    return a


def chol_body(p: int, q: int) -> dict:
    """The Cholesky cases, dist_potrf at lookahead depths 0, 1 and 2 (with
    and without ABFT, and under each planted strike), the health of an
    indefinite matrix under Info and Raise, and the queue-1 item-12
    drivers on this grid (:func:`refusals`)."""
    import slate_tpu_torch as st
    from slate_tpu_torch.parallel.dist_chol import dist_potrf
    from slate_tpu_torch.robust import faults
    g = mesh_grid(st, p, q)
    out = {"cases": run_cases(p, q, "chol")}
    for dt in ("float32", "float64"):
        S = st.HermitianMatrix.from_numpy(chol_storage_array(dt), NB,
                                          st.Uplo.Lower, grid=g).storage
        for abft in (False, True):
            out[f"potrf_{dt}_{abft}"] = [
                [x.numpy().copy() for x in dist_potrf(
                    S.data, S.Nt, g, S.n, abft=abft, la=la)]
                for la in (0, 1, 2)]
        for site, kw in CHOL_STRIKES.items():
            runs = []
            with faults.inject(faults.FaultPlan(site, **kw)):
                for la in (0, 1, 2):
                    runs.append([x.numpy().copy() for x in dist_potrf(
                        S.data, S.Nt, g, S.n, abft=True, la=la)])
            out[f"strike_{site}_{dt}"] = runs
    mesh = {st.Option.Target: st.Target.mesh}
    A = st.HermitianMatrix.from_numpy(indefinite(), NB, st.Uplo.Lower,
                                      grid=g)
    _, h = st.potrf(A, {**mesh, st.Option.ErrorPolicy: st.ErrorPolicy.Info})
    out["indefinite_info"] = (h.info, h.min_pivot_index, h.nonfinite)
    try:
        st.potrf(A, mesh)
        out["indefinite_raise"] = None
    except st.SlateNotPositiveDefiniteError as e:
        out["indefinite_raise"] = e.info
    out["refusals"] = refusals(st, g)
    return out


def refusals(st, g) -> dict:
    """Each queue-1 item-12b and item-12c driver on this grid with
    Target.mesh (drivers that once refused a grid with a process group):
    the result as numpy data.  A is ``inputs("float64")["spd"]``, H its
    ``herm``, B its ``rhs`` (n = 23 in 4 x 4 tiles); stedc takes the
    tridiagonal (linspace(-1, 1, N), 0.3)."""
    x = inputs("float64")
    o = {st.Option.Target: st.Target.mesh}
    A = st.Matrix.from_numpy(x["spd"], NB, NB, grid=g)
    H = st.HermitianMatrix.from_numpy(x["herm"], NB, st.Uplo.Lower, grid=g)
    B = st.Matrix.from_numpy(x["rhs"], NB, NB, grid=g)

    def lu():
        F = st.getrf(A, o)
        return _np(F.LU), _np(F.perm)

    calls = {"gesv": lambda: _np(st.gesv(A, B, o)[1]), "getrf": lu,
             "gels": lambda: _np(st.gels(A, B, o)),
             "geqrf": lambda: _np(st.geqrf(A, o).QR),
             "heev": lambda: tuple(_np(v) for v in st.heev(H, o)),
             "svd": lambda: tuple(_np(v) for v in st.svd(A, o)),
             "hetrf": lambda: _he_factors(st.hetrf(H, o)),
             "hesv": lambda: _np(st.hesv(H, B, o)[1]),
             "stedc": lambda: tuple(_np(v) for v in st.stedc(
                 *stedc_refusal_input(), grid=g))}
    return {name: call() for name, call in calls.items()}


def stedc_refusal_input():
    """The tridiagonal the drivers' grid check gives stedc."""
    return np.linspace(-1.0, 1.0, N), np.full(N - 1, 0.3)


# ------------------------------------------- distributed LU and Aasen

LU_NB = {"a22": 5, "a24": 4, "d18": 4, "d24": 4, "h24": 4}


def lu_inputs(dtype: str, seed: int = 18) -> dict:
    """The LU and Aasen operands in ``dtype``: ragged general matrices
    (22 in 5 x 5 tiles, 24 in 4 x 4), diagonally dominant ones for NoPiv
    (18, 24), a Hermitian indefinite 24 x 24 and right-hand sides."""
    rng = np.random.default_rng(seed)
    out = {}
    for key in ("a22", "a24", "d18", "d24", "h24"):
        n = int(key[1:])
        x = _rng_matrix(rng, dtype, n, n)
        if key[0] == "d":
            x = x + n * np.eye(n, dtype=dtype)
        if key[0] == "h":
            x = (x + x.conj().T) / 2
        out[key] = x.astype(dtype)
        out["b" + key[1:]] = _rng_matrix(rng, dtype, n, 3)
    return out


def _np(v):
    """A driver's output as numpy: a matrix densified, a tensor or array
    copied to the host."""
    if hasattr(v, "to_numpy") or hasattr(v, "to_dense"):
        return dense(v)
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


_LU_FACTOR = {"partial": "getrf", "calu": "getrf_tntpiv",
              "nopiv": "getrf_nopiv"}


def _lu_factor(method, which):
    """getrf / getrf_tntpiv / getrf_nopiv of ``which``: (LU, perm)."""
    def call(st, M, x, o):
        F = getattr(st, _LU_FACTOR[method])(M(x[which], nb=LU_NB[which]), o)
        return F.LU, F.perm
    return call


def _gesv(which, method):
    def call(st, M, x, o):
        o = {**o, st.Option.MethodLU: getattr(st.MethodLU, method)}
        nb = LU_NB[which]
        _, X = st.gesv(M(x[which], nb=nb), M(x["b" + which[1:]], nb=nb), o)
        return X
    return call


def _gesv_nopiv(st, M, x, o):
    return st.gesv_nopiv(M(x["d18"]), M(x["b18"]), o)[1]


def _gesv_speculate(which):
    """gesv under Speculate: the RBT rung (a24: 24 = Mt nb, a multiple of
    the butterfly's 4, on the tiles; a22 in 5 x 5 tiles: 25 is not, so
    the dense transform), accepted on these matrices."""
    def call(st, M, x, o):
        o = {**o, st.Option.Speculate: st.options.Speculate.On,
             st.Option.ErrorPolicy: st.ErrorPolicy.Info}
        nb = LU_NB[which]
        F, X, h = st.gesv(M(x[which], nb=nb), M(x["b" + which[1:]], nb=nb),
                          o)
        return X, type(F).__name__, h.ok
    return call


def _rbt_factor(which):
    """getrf_rbt: the NoPiv factor of the transformed matrix."""
    def call(st, M, x, o):
        return st.getrf_rbt(M(x[which], nb=LU_NB[which]), o).F.LU
    return call


def _getrs_mb4(st, M, x, o):
    """getrs with B in 4-row tiles against a factor in 5 x 5 tiles (ref:
    tests/test_lu.py:123-135)."""
    F = st.getrf(M(x["a22"], nb=5), o)
    return st.getrs(F, M(x["b22"], nb=4), o)


def _getri(st, M, x, o):
    return st.getri(st.getrf(M(x["a22"], nb=5), o), o)


LU_CASES = [
    ("getrf_partial", "float64", _lu_factor("partial", "a22")),
    ("getrf_partial", "float32", _lu_factor("partial", "a22")),
    ("getrf_calu", "float64", _lu_factor("calu", "a24")),
    ("getrf_nopiv", "complex128", _lu_factor("nopiv", "d18")),
    ("getrf_rbt_tiles", "float64", _rbt_factor("a24")),
    ("getrf_rbt_dense", "float64", _rbt_factor("a22")),
    ("getrs_mb4", "float64", _getrs_mb4),
]

# held against numpy's solve and inverse (the reference's mesh gesv is
# getrf and getrs, held above; its compiles are what a test pays for)
LU_SOLVES = [
    ("gesv_partial", "float32", _gesv("a22", "PartialPiv")),
    ("gesv_partial", "float64", _gesv("a22", "PartialPiv")),
    ("gesv_calu", "float64", _gesv("a24", "CALU")),
    ("gesv_calu", "complex128", _gesv("a24", "CALU")),
    ("gesv_nopiv", "complex128", _gesv_nopiv),
    ("gesv_speculate_tiles", "float64", _gesv_speculate("a24")),
    ("gesv_speculate_dense", "float64", _gesv_speculate("a22")),
    ("getri", "float64", _getri),
]


def lu_solve_want(name: str, dt: str):
    """numpy's answer to an LU_SOLVES case, in f64 or complex128."""
    x = lu_inputs(ref_dtype(dt))
    if name == "getri":
        return np.linalg.inv(x["a22"])
    which = {"gesv_partial": "22", "gesv_calu": "24", "gesv_nopiv": "18",
             "gesv_speculate_tiles": "24", "gesv_speculate_dense": "22"}[name]
    a = x[("d" if name == "gesv_nopiv" else "a") + which]
    return np.linalg.solve(a, x["b" + which])


# the lookahead runs: dist_getrf on the reference's test_lookahead.py
# matrix shape (21 in 4 x 4 tiles), every method with and without ABFT
LA_METHODS = ("partial", "nopiv", "tntpiv")


def la_lu_array(dt: str, n: int = 21, seed: int = 21) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)) + n * np.eye(n)).astype(dt)


# a planted post_panel strike on a mesh gesv under Abft (ref:
# tests/test_abft.py:275-292): the last tile row of the first panel
STRIKE_N, STRIKE_NB = 24, 4
LU_STRIKE = dict(kind="bitflip", seed=11, tile=(STRIKE_N // STRIKE_NB - 1, 0),
                 nb=STRIKE_NB)


def strike_system():
    rng = np.random.default_rng(24)
    n = STRIKE_N
    return (rng.standard_normal((n, n)) + n * np.eye(n),
            rng.standard_normal((n, 3)))


def _he_factors(F):
    """Aasen factors as numpy: (L, T, piv)."""
    return _np(F.L), _np(F.T_dense()), _np(F.piv)


def lu_body(p: int, q: int) -> dict:
    """The LU and Aasen cases on a p x q grid with Target.mesh: every case
    of LU_CASES and LU_SOLVES, the factor's local tiles, dist_getrf at
    lookahead depths 0, 1 and 2, a planted strike on a mesh gesv under
    Abft, the mesh Aasen (hetrf, hesv) and an indefinite posv through its
    ladder."""
    import slate_tpu_torch as st
    from slate_tpu_torch.parallel.dist_lu import dist_getrf
    from slate_tpu_torch.robust import faults
    g = mesh_grid(st, p, q)
    r, c = g.coords
    M = matrix_maker(st, g)
    o = {st.Option.Target: st.Target.mesh}
    out = {"coords": (r, c), "cases": {}}
    for case in LU_CASES + LU_SOLVES:
        _, dt, call = case
        res = call(st, M, lu_inputs(dt), o)
        res = res if isinstance(res, tuple) else (res,)
        out["cases"][case_id(case)] = tuple(
            v if isinstance(v, (str, bool)) else _np(v) for v in res)
    F = st.getrf(M(lu_inputs("float64")["a22"], nb=5), o)
    out["local_getrf"] = F.LU.storage.data.numpy().copy()
    for dt in ("float32", "float64"):
        S = st.Matrix.from_numpy(la_lu_array(dt), NB, NB, grid=g).storage
        for method in LA_METHODS:
            for abft in (False, True):
                out[f"la_{method}_{dt}_{abft}"] = [
                    [_np(v) for v in dist_getrf(S.data, S.Nt, g, S.n, method,
                                                abft=abft, la=la)]
                    for la in (0, 1, 2)]
    a, b = strike_system()
    info = {**o, st.Option.Abft: st.Abft.On,
            st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    A = M(a)
    B = M(b)
    _, X0, h0 = st.gesv(A, B, info)
    with faults.inject(faults.FaultPlan("post_panel", **LU_STRIKE)):
        _, X, h = st.gesv(A, B, info)
    out["strike"] = {"clean": (h0.abft_detected, h0.abft_corrected, h0.ok),
                     "struck": (h.abft_detected, h.abft_corrected,
                                h.abft_site, h.ok),
                     "x": _np(X), "x_clean": _np(X0)}
    for dt in ("float64", "complex128"):
        x = lu_inputs(dt)
        H = M(x["h24"], "herm", st.Uplo.Lower)
        out[f"hetrf_{dt}"] = _he_factors(st.hetrf(H, o))
        F, X = st.hesv(H, M(x["b24"]), o)
        out[f"hesv_{dt}"] = _np(X)
    x = lu_inputs("float64")
    F, X, h = st.posv(M(x["h24"], "herm", st.Uplo.Lower), M(x["b24"]),
                      {**o, st.Option.ErrorPolicy: st.ErrorPolicy.Info})
    out["posv_indefinite"] = (type(F).__name__, h.ok, _np(X))
    return out


# ---------------------------------------------------- distributed QR

QR_SHAPES = {"a24": (24, 24), "a37": (37, 15), "a48": (48, 8),
             "w15": (15, 37)}


def qr_inputs(dtype: str, seed: int = 37) -> dict:
    """The QR operands in ``dtype`` (4 x 4 tiles): 24 x 24, 37 x 15, 48 x 8
    and a wide 15 x 37, their right-hand sides, and the unmqr operands
    (37 x 7 from the left, 7 x 37 from the right)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, (m, n) in QR_SHAPES.items():
        out[key] = _rng_matrix(rng, dtype, m, n)
        out["b" + key[1:]] = _rng_matrix(rng, dtype, m, 3)
    out["cl"] = _rng_matrix(rng, dtype, 37, 7)
    out["cr"] = _rng_matrix(rng, dtype, 7, 37)
    return out


def _gels(which, method):
    def call(st, M, x, o):
        o = {**o, st.Option.MethodGels: getattr(st.MethodGels, method)}
        return st.gels(M(x[which]), M(x["b" + which[1:]]), o)
    return call


def _unmqr(side, op):
    def call(st, M, x, o):
        F = st.geqrf(M(x["a37"]), o)
        return st.unmqr(side, op, F, M(x["cl" if side == "l" else "cr"]), o)
    return call


def _geqrf(st, M, x, o):
    F = st.geqrf(M(x["a37"]), o)
    return F.QR, F.Tloc, F.Vtree, F.Ttree


def _gelqf_unmlq(st, M, x, o):
    """unmlq of gelqf's Q (the wide 15 x 37 A's) from the left on a
    37 x 7 C, with op 'c'."""
    F = st.gelqf(M(x["w15"]), o)
    return st.unmlq("l", "c", F, M(x["cl"]), o)


# held against the reference's mesh drivers on a grid of the same p
# (CAQR's factors depend on the grid rows: its tree stacks their R's)
QR_GRID_CASES = [
    ("geqrf", "float64", _geqrf),
    ("unmqr_ln", "float64", _unmqr("l", "n")),
    ("unmqr_lc", "float64", _unmqr("l", "c")),
    ("unmqr_rn", "float64", _unmqr("r", "n")),
    ("unmqr_rc", "float64", _unmqr("r", "c")),
    ("gelqf_unmlq", "float64", _gelqf_unmlq),
]

# grid-independent: held against the reference's mesh drivers on 2 x 2
QR_CASES = [
    ("gels_qr", "float64", _gels("a37", "QR")),
    ("gels_qr", "float32", _gels("a37", "QR")),
    ("gels_qr_square", "complex128", _gels("a24", "QR")),
    ("gels_cholqr", "float64", _gels("a48", "CholQR")),
    ("gels_min_norm", "float64", _gels("w15", "QR")),
]


def la_qr_array(dt: str, m: int = 22, n: int = 17, seed: int = 22):
    """The reference's test_lookahead.py CAQR shape, one input."""
    return np.random.default_rng(seed).standard_normal((m, n)).astype(dt)


SCALAPACK_N, SCALAPACK_NB = 22, 4


def scalapack_system():
    rng = np.random.default_rng(99)
    n = SCALAPACK_N
    return (rng.standard_normal((n, n)) + n * np.eye(n),
            rng.standard_normal((n, 3)), rng.standard_normal((37, 15)),
            rng.standard_normal((37, 3)))


def qr_body(p: int, q: int) -> dict:
    """The QR cases on a p x q grid with Target.mesh, dist_geqrf at
    lookahead depths 0, 1 and 2, and from_scalapack / to_scalapack /
    pdgesv / pdgels / pdsyev / pdgesvd over the grid's ScaLAPACK
    locals."""
    import slate_tpu_torch as st
    from slate_tpu_torch.compat import scalapack as sc
    from slate_tpu_torch.compat import scalapack_api as sapi
    from slate_tpu_torch.core.layout import num_tiles
    from slate_tpu_torch.parallel.dist_qr import dist_geqrf_data
    g = mesh_grid(st, p, q)
    r, c = g.coords
    M = matrix_maker(st, g)
    o = {st.Option.Target: st.Target.mesh}
    out = {"coords": (r, c), "cases": {}}
    for case in QR_GRID_CASES + QR_CASES:
        _, dt, call = case
        res = call(st, M, qr_inputs(dt), o)
        res = res if isinstance(res, tuple) else (res,)
        out["cases"][case_id(case)] = tuple(_np(v) for v in res)
    F = st.geqrf(M(qr_inputs("float64")["a37"]), o)
    out["local_geqrf"] = F.QR.storage.data.numpy().copy()
    for dt in ("float32", "float64"):
        a = la_qr_array(dt)
        S = st.Matrix.from_numpy(a, NB, NB, grid=g).storage
        out[f"la_qr_{dt}"] = [
            [_np(v) for v in dist_geqrf_data(
                S.data, num_tiles(a.shape[1], NB), num_tiles(a.shape[0], NB),
                a.shape[0], a.shape[1], g, la=la)]
            for la in (0, 1, 2)]
    a, b, aq, bq = scalapack_system()
    nb = SCALAPACK_NB
    da, la_ = sc.scatter_locals(a, nb, nb, p, q)
    db, lb = sc.scatter_locals(b, nb, nb, p, q)
    A = sc.from_scalapack(da, la_, g)
    out["scalapack_local"] = A.storage.data.numpy().copy()
    back = sc.to_scalapack(A)[1]
    out["scalapack_round_trip"] = all(
        np.array_equal(back[k], la_[k]) for k in la_)
    dx, lx = sapi.pdgesv(SCALAPACK_N, 3, da, la_, db, lb, g)
    out["pdgesv"] = sc.gather_locals(dx, lx, p, q)
    dq, lq = sc.scatter_locals(aq, nb, nb, p, q)
    dbq, lbq = sc.scatter_locals(bq, nb, nb, p, q)
    dx, lx = sapi.pdgels(37, 15, 3, dq, lq, dbq, lbq, g)
    out["pdgels"] = sc.gather_locals(dx, lx, p, q)
    w, dz, lz = sapi.pdsyev("v", "l", SCALAPACK_N, da, la_, g)
    out["pdsyev"] = (w, sc.gather_locals(dz, lz, p, q))
    sv, du, lu, dvt, lvt = sapi.pdgesvd("v", SCALAPACK_N, SCALAPACK_N, da,
                                        la_, g)
    out["pdgesvd"] = (sv, sc.gather_locals(du, lu, p, q),
                      sc.gather_locals(dvt, lvt, p, q))
    return out


def blas3_world(p: int, q: int) -> dict:
    """The rank body of test_torch_dist_blas3.py: the storage layout, the
    collectives, norm and redistribute, the BLAS-3 cases and SUMMA at
    every depth, in one world."""
    out = core_body(p, q)
    out.update(blas3_body(p, q))
    return out


def deadlock_body() -> None:
    """Rank 0 never enters the barrier that rank 1 waits in."""
    import time
    import torch.distributed as dist
    if dist.get_rank() == 0:
        time.sleep(600)
    dist.barrier()


# ------------------------------------- distributed spectral reductions

# tile sizes: h37 and g37 are ragged (37 = 7*5 + 2, 23 = 5*4 + 3)
SPEC_NB = {"h23": 4, "h37": 5, "h16": 4, "b23": 4, "g23": 4, "g16": 4,
           "g24": 4, "g37": 5}


def spec_inputs(seed: int = 19) -> dict:
    """The spectral operands, numpy: Hermitian h23 (f64), h37 and h16
    (complex128), an SPD b23 for hegv, general g23 (23 x 16, tall), g16
    (16 x 23, wide), g24 (24 x 24, complex128) and g37 (37 x 23, the
    reference's tests/test_svd.py:73 shape), and a tridiagonal (d40,
    e39)."""
    rng = np.random.default_rng(seed)

    def herm(n, dt):
        x = _rng_matrix(rng, dt, n, n)
        return ((x + x.conj().T) / 2).astype(dt)

    out = {"h23": herm(23, "float64"), "h37": herm(37, "complex128"),
           "h16": herm(16, "complex128")}
    g = rng.standard_normal((23, 23))
    out["b23"] = g @ g.T + 23 * np.eye(23)
    out["g23"] = _rng_matrix(rng, "float64", 23, 16)
    out["g16"] = _rng_matrix(rng, "float64", 16, 23)
    out["g24"] = _rng_matrix(rng, "complex128", 24, 24)
    out["g37"] = _rng_matrix(rng, "float64", 37, 23)
    out["d40"] = rng.standard_normal(40)
    out["e39"] = rng.standard_normal(39)
    return out


def spec_herm(st, M, x, which, uplo="l"):
    U = st.Uplo.Lower if uplo == "l" else st.Uplo.Upper
    return M(x[which], "herm", U, nb=SPEC_NB[which])


def _heev_case(which, meth="Auto", uplo="l", view=None, vals=False):
    def call(st, M, x, o):
        A = spec_herm(st, M, x, which, uplo)
        if view == "t":
            A = A.transpose()
        o = {**o, st.Option.MethodEig: getattr(st.MethodEig, meth)}
        return (st.heev_vals(A, o),) if vals else st.heev(A, o)
    return call


def _svd_case(which, meth="Auto", vals=False):
    def call(st, M, x, o):
        A = M(x[which], nb=SPEC_NB[which])
        o = {**o, st.Option.MethodSvd: getattr(st.MethodSvd, meth)}
        return (st.svd_vals(A, o),) if vals else st.svd(A, o)
    return call


def _api_case(verb, which):
    """The simplified API's spectral verb on the case's matrix."""
    def call(st, M, x, o):
        A = (spec_herm(st, M, x, which) if verb.startswith("eig")
             else M(x[which], nb=SPEC_NB[which]))
        out = getattr(st.api, verb)(A, o)
        return out if isinstance(out, tuple) else (out,)
    return call


def _hegv_case(itype, uplo="l"):
    def call(st, M, x, o):
        B = spec_herm(st, M, x, "b23", uplo)
        return st.hegv(spec_herm(st, M, x, "h23"), B, o, itype=itype)
    return call


def spec_matrix(name: str) -> np.ndarray:
    """The dense matrix a SPEC_CASES case decomposes (its view applied)."""
    x = spec_inputs()
    if name == "heev_trans_view":
        return x["h37"].T
    for key in ("h23", "h37", "g23", "g16", "g24", "g37"):
        if name.endswith(key):
            return x[key]
    return x["h23"]


# (name, call, whether the reference's mesh result is held beside numpy's)
SPEC_CASES = [
    ("heev_auto_h23", _heev_case("h23"), True),
    ("heev_dc_h23", _heev_case("h23", "DC"), True),
    ("heev_qr_h23", _heev_case("h23", "QR"), True),
    ("heev_auto_h37", _heev_case("h37"), False),
    ("heev_trans_view", _heev_case("h37", view="t"), False),
    ("heev_upper_h23", _heev_case("h23", uplo="u"), False),
    ("heev_vals_h23", _heev_case("h23", vals=True), True),
    ("svd_auto_g23", _svd_case("g23"), True),
    ("svd_bidiag_g23", _svd_case("g23", "Bidiag"), True),
    ("svd_auto_g37", _svd_case("g37"), False),
    ("svd_wide_g16", _svd_case("g16"), False),
    ("svd_complex_g24", _svd_case("g24"), False),
    ("svd_vals_g23", _svd_case("g23", vals=True), True),
    ("api_eig_h23", _api_case("eig", "h23"), True),
    ("api_eig_vals_h37", _api_case("eig_vals", "h37"), False),
    ("api_svd_g23", _api_case("svd", "g23"), True),
    ("api_svd_vals_g16", _api_case("svd_vals", "g16"), False),
]
HEGV_CASES = [(itype, uplo) for itype in (1, 2, 3) for uplo in ("l", "u")]


def spectral_body(p: int, q: int) -> dict:
    """The distributed spectral reductions on a p x q grid: dist_he2hb's
    and dist_ge2tb's packings and Ts (and their local tiles) and their
    lookahead depths 0, 1 and 2, the SPEC_CASES drivers with Target.mesh,
    stedc on the grid, hegv (every itype, B stored either way), pdsyev
    and pdgesvd over the grid's ScaLAPACK locals, and a post_stage1
    strike that the heev ladder escalates."""
    import torch
    import slate_tpu_torch as st
    from slate_tpu_torch.compat import scalapack as sc
    from slate_tpu_torch.compat import scalapack_api as sapi
    from slate_tpu_torch.core.storage import TileStorage
    from slate_tpu_torch.parallel.dist_ge2tb import dist_ge2tb
    from slate_tpu_torch.parallel.dist_he2hb import dist_he2hb
    from slate_tpu_torch.robust import faults
    g = mesh_grid(st, p, q)
    M = matrix_maker(st, g)
    o = {st.Option.Target: st.Target.mesh}
    x = spec_inputs()
    out = {"coords": g.coords, "cases": {}}
    for which in ("h23", "h37"):
        S = spec_herm(st, M, x, which).storage
        runs = [[v.numpy().copy() for v in dist_he2hb(
            S.data, S.Nt, g, n=S.n, la=la)] for la in (0, 1, 2)]
        out[f"he2hb_{which}"] = (
            TileStorage(torch.from_numpy(runs[0][0]), S.m, S.n, S.mb, S.nb,
                        g).to_dense().numpy(), runs[0][1], runs[0][0])
        out[f"he2hb_depths_{which}"] = runs
    for which in ("g23", "g24"):
        S = M(x[which], nb=SPEC_NB[which]).storage
        runs = [[v.numpy().copy() for v in dist_ge2tb(
            S.data, S.Mt, S.Nt, S.m, S.n, g, la=la)] for la in (0, 1, 2)]
        out[f"ge2tb_{which}"] = (
            TileStorage(torch.from_numpy(runs[0][0]), S.m, S.n, S.mb, S.nb,
                        g).to_dense().numpy(), runs[0][1], runs[0][2],
            runs[0][0])
        out[f"ge2tb_depths_{which}"] = runs
    for name, call, _ in SPEC_CASES:
        out["cases"][name] = tuple(_np(v) for v in call(st, M, x, o))
    out["stedc"] = tuple(_np(v) for v in st.stedc(x["d40"], x["e39"],
                                                   grid=g))
    for itype, uplo in HEGV_CASES:
        out[f"hegv_{itype}{uplo}"] = tuple(
            _np(v) for v in _hegv_case(itype, uplo)(st, M, x, o))
    nb = SPEC_NB["h23"]
    da, la_ = sc.scatter_locals(x["h23"], nb, nb, p, q)
    w, dz, lz = sapi.pdsyev("v", "l", 23, da, la_, g)
    zd = _np(st.heev(st.HermitianMatrix._from_view(
        sc.from_scalapack(da, la_, g), st.Uplo.Lower))[1])
    out["pdsyev"] = (w, sc.gather_locals(dz, lz, p, q),
                     _same_locals(lz, sc.scatter_locals(zd, nb, nb, p, q)))
    dg, lg = sc.scatter_locals(x["g23"], nb, nb, p, q)
    s, du, lu, dvt, lvt = sapi.pdgesvd("v", 23, 16, dg, lg, g)
    _, U, V = st.svd(sc.from_scalapack(dg, lg, g))
    out["pdgesvd"] = (
        s, sc.gather_locals(du, lu, p, q), sc.gather_locals(dvt, lvt, p, q),
        _same_locals(lu, sc.scatter_locals(_np(U), nb, nb, p, q))
        and _same_locals(lvt, sc.scatter_locals(_np(V).conj().T, nb, nb,
                                                p, q)))
    plan = faults.FaultPlan("post_stage1", kind="nan", seed=17, count=4,
                            transient=True)
    info = {**o, st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    with faults.inject(plan), st.obs.recording() as evs:
        w, Z, h = st.heev(spec_herm(st, M, x, "h23"), info)
    out["strike"] = (h.ok, evs[-1].get("path"), _np(w), _np(Z))
    return out


def _same_locals(got: dict, want) -> bool:
    """ScaLAPACK locals bit for bit those of ``want`` = (desc, locals)."""
    return all(np.array_equal(np.asarray(got[k]), v)
               for k, v in want[1].items())


# ------------------------------------------------ the tester and examples

def tester_body(argvs) -> list:
    """Each command line of ``argvs`` through ``slate_tpu_torch.tester`` on
    this rank: (exit code, rows, what it printed)."""
    import contextlib
    import io
    from slate_tpu_torch import tester
    out = []
    for argv in argvs:
        buf, rows = io.StringIO(), []
        with contextlib.redirect_stdout(buf):
            rc = tester.main(argv, rows)
        out.append((rc, rows, buf.getvalue()))
    return out


def examples_body(names) -> tuple:
    """The named examples on this rank, on the CPU: (the failed ones, what
    it printed)."""
    import contextlib
    import io
    import torch
    from slate_tpu_torch.examples import run_all
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        failed = run_all.run(names, torch.device("cpu"))
    return failed, buf.getvalue()
