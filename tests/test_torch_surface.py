"""The port's public surface against the reference's.

Every name that a package or subpackage ``__init__`` of slate_tpu exports
is exported by the same ``__init__`` of slate_tpu_torch, unless the
README's port section lists it as JAX-only; and each name on that list
is one the reference defines and the port does not bind, so the list
stays true.  Both packages' files are read with ast: neither is imported
for it.  Then the names that were new to the port in the same change
(``poison``, ``Layout``, ``XLA_PLAN``, ``version``/``id``) against the
reference's.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import ast
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "slate_tpu", ROOT / "slate_tpu_torch"
# README lines of the JAX-only list: "- `slate_tpu/<module>.py` `<NAME>`: ..."
JAX_ONLY = re.compile(r"^\s*- `slate_tpu/([\w/]+\.py)` `(\w+)`")


def _bound(path: pathlib.Path, imports: bool = True) -> set:
    """Public names a module binds at its top level: its definitions and
    assignments, and with ``imports`` what it imports."""
    out = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update(a.asname or a.name.split(".")[0] for a in node.names)
    return {n for n in out if not n.startswith("_")} | (
        {"__version__"} & out)


def _jax_only() -> set:
    text = (ROOT / "README.md").read_text()
    return {m.groups() for m in map(JAX_ONLY.match, text.splitlines()) if m}


def test_every_reference_export_has_a_port_counterpart():
    listed = _jax_only()
    inits = sorted(REF.rglob("__init__.py"))
    assert len(inits) > 10
    missing = []
    for init in inits:
        rel = init.relative_to(REF)
        port = PORT / rel
        assert port.exists(), rel
        have = _bound(port)
        missing += [(str(rel), name) for name in sorted(_bound(init))
                    if name not in have and (str(rel), name) not in listed]
    assert missing == []


def test_the_readme_jax_only_list_is_true():
    listed = _jax_only()
    assert ("core/grid.py", "TILE_SPEC") in listed
    assert ("comm/collectives.py", "my_coords") in listed
    for module, name in listed:
        assert name in _bound(REF / module, imports=False), (module, name)
        assert name not in _bound(PORT / module), (module, name)


def test_poison_nan_fills_floating_leaves_where_the_health_is_bad():
    """poison over nested tuples, lists and dicts: NaN in every floating
    and complex leaf when the health is bad, integer leaves kept, the
    tree returned as it was when it is good; the reference's poison on the
    same tree gives the same NaN pattern."""
    import slate_tpu as ref
    import slate_tpu_torch as st
    rng = np.random.default_rng(5)
    leaves = [rng.standard_normal((3, 2)).astype(np.float32),
              np.arange(4, dtype=np.int64),
              (rng.standard_normal(3) + 1j).astype(np.complex64),
              rng.standard_normal(2)]

    def tree(wrap):
        a, b, c, d = (wrap(x) for x in leaves)
        return (a, [b, {"c": c}], d)

    bad = st.robust.healthy()._replace(info=3)
    got = st.robust.poison(tree(torch.from_numpy), bad)
    want = ref.robust.poison(tree(jnp.asarray),
                             ref.robust.healthy()._replace(
                                 info=jnp.asarray(3, jnp.int32)))
    flat = [got[0], got[1][0], got[1][1]["c"], got[2]]
    wflat = [want[0], want[1][0], want[1][1]["c"], want[2]]
    for g, w, x in zip(flat, wflat, leaves):
        assert g.shape == x.shape
        np.testing.assert_array_equal(np.isnan(g.numpy()),
                                      np.isnan(np.asarray(w)))
    np.testing.assert_array_equal(flat[1].numpy(), leaves[1])
    assert all(torch.isnan(t).all() for t in (flat[0], flat[2], flat[3]))
    good = tree(torch.from_numpy)
    assert st.robust.poison(good, st.robust.healthy()) is good
    M = st.Matrix.from_numpy(leaves[0], 2, device="cpu")
    assert torch.isnan(st.robust.poison(M, bad).to_dense()).all()


def test_the_new_names_carry_the_references_values():
    import slate_tpu as ref
    import slate_tpu_torch as st
    assert {e.name: e.value for e in st.Layout} == {
        e.name: e.value for e in ref.Layout}
    assert st.version() == ref.version()
    assert st.id().split()[1] == ref.id().split()[1]
    # the no-cache plan: what every seam resolves to without a cache
    assert st.tune.XLA_PLAN == st.tune.plans.default_plan("potrf_tile",
                                                          "float32")
    assert st.CAQRFactors is st.drivers.qr.CAQRFactors
    assert st.drivers.blas3.gemm is st.gemm
