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
    indefinite matrix under Info and Raise, and the 12b drivers' refusal
    on this grid."""
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
    """Each queue-1 item-12b driver on this grid: the message it raised
    (NotImplementedError), or what it returned instead."""
    x = inputs("float64")
    A = st.Matrix.from_numpy(x["spd"], NB, NB, grid=g)
    H = st.HermitianMatrix.from_numpy(x["herm"], NB, st.Uplo.Lower, grid=g)
    B = st.Matrix.from_numpy(x["rhs"], NB, NB, grid=g)
    calls = {"gesv": lambda: st.gesv(A, B), "getrf": lambda: st.getrf(A),
             "gels": lambda: st.gels(A, B), "geqrf": lambda: st.geqrf(A),
             "heev": lambda: st.heev(H), "svd": lambda: st.svd(A),
             "hetrf": lambda: st.hetrf(H), "hesv": lambda: st.hesv(H, B),
             "stedc": lambda: st.stedc(np.ones(N), np.ones(N - 1), grid=g,
                                       device="cpu")}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = "returned"
        except NotImplementedError as e:
            out[name] = str(e)
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
