"""slate-lint for the port (slate_tpu_torch/lint/): the SEAM, CON and OBS
packs of tests/test_slate_lint.py restated for the port's paths and torch
spellings.

Every rule fires on a mini tree under tmp_path and stays silent on its
compliant twin; the port's own tree is clean under every rule (one
project load for the module); copies of the real serving modules with one
guarded access moved out of its lock are caught; the command line's exit
codes are 0, 1 and 2.  The lint is pure stdlib: nothing here needs jax or
a GPU, and the lint's own modules import only the standard library.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import ast
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

from slate_tpu_torch.lint import cli, load_project, loader
from slate_tpu_torch.lint.model import (REGISTRY, SUPPRESS_RE,
                                        parse_suppressions)
from slate_tpu_torch.lint.rules import concurrency as con
from slate_tpu_torch.lint.rules import seams

REPO = pathlib.Path(__file__).resolve().parent.parent
P = "slate_tpu_torch"

cli.load_rules()

#: the reference's three contract packs, no more and no fewer
PACK_IDS = ([f"SEAM{i:03d}" for i in range(1, 15)]
            + ["CON001", "CON002", "CON003", "OBS001", "OBS002"])
SEAM_IDS = {r for r in PACK_IDS if r.startswith("SEAM")}


def mini_repo(tmp_path, files):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return tmp_path


def lint(root, select):
    return cli.run_rules(load_project(root), select=set(select))


def rule_ids(findings):
    return {f.rule for f in findings}


# --------------------------------------------------------------------------
# the port's tree


@pytest.fixture(scope="module")
def port_project():
    return load_project(REPO)


@pytest.fixture(scope="module")
def port_findings(port_project):
    return cli.run_rules(port_project)


def test_registry_is_the_three_packs():
    assert sorted(REGISTRY) == sorted(PACK_IDS)


@pytest.mark.parametrize("rule", PACK_IDS)
def test_port_tree_is_clean(port_findings, rule):
    """The tier-1 gate: the port's tree raises no finding under any rule
    (tolerated sites carry an inline suppression with a reason)."""
    assert [f.render() for f in port_findings if f.rule == rule] == []


def test_port_scan_covers_the_package_but_not_its_examples(port_project):
    rels = set(port_project.modules)
    assert {f"{P}/drivers/cholesky.py", f"{P}/serve/server.py",
            f"{P}/lint/cli.py"} <= rels
    assert all(r.startswith(f"{P}/") for r in rels)
    assert not any(r.startswith(f"{P}/examples/") for r in rels)


def test_port_suppressions_all_give_a_reason(port_project):
    """Every suppression comment in the port says why after ``--``."""
    reasons = []
    for mod in port_project.modules.values():
        for line, text, _ in loader._comments(mod.text):
            m = SUPPRESS_RE.search(text)
            if m:
                reasons.append((mod.rel, line, m.group("reason") or ""))
    assert len(reasons) >= 18
    assert [r for r in reasons if len(r[2].split()) < 5] == []


def test_the_site_forwarder_of_the_port_is_found(port_project):
    fwd = seams.site_forwarders(port_project)
    assert fwd["_corrupt_storage"] == (0, "site")


def test_lint_imports_only_the_standard_library():
    """The analyzer parses the tree and never imports it: no torch, no jax,
    nothing of slate_tpu, tools or the rest of the port."""
    bad = []
    for path in sorted((REPO / P / "lint").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif isinstance(node, ast.ImportFrom) and node.level > 2:
                names = ["<outside the lint package>"]
            bad += [(path.name, n) for n in names
                    if n.split(".")[0] not in sys.stdlib_module_names]
    assert bad == []


# --------------------------------------------------------------------------
# seam pack (SEAM001-SEAM014): a clean skeleton, mutated per rule


def _driver(fn):
    return (f"from ..robust import health\n\n\n"
            f"def {fn}(a, opts=None):\n    return health.finalize(a)\n")


RECOVERY = """\
    def gesv_with_recovery(a, opts=None):
        spec = resolve_speculate(opts)
        ab = resolve_abft(opts)
        r = bounded_retry(a)
        return finalize(r)


    def gels_with_recovery(a, opts=None):
        spec = resolve_speculate(opts)
        low = resolve_precision(opts)
        r = bounded_retry(a)
        return finalize(r)


    def hesv_with_recovery(a, opts=None):
        spec = resolve_speculate(opts)
        r = bounded_retry(a)
        return finalize(r)


    def posv_with_recovery(a, opts=None):
        spec = resolve_speculate(opts)
        low = resolve_precision(opts)
        ab = resolve_abft(opts)
        r = bounded_retry(a)
        return finalize(r)
    """

BATCHED = """\
    def batch_program(op, opts, a):
        low = resolve_precision(opts)
        return op


    def make_batched(op, opts=None):
        def fn(a, b, sizes):
            return batch_program(op, opts, a)
        return fn
    """


def seam_skeleton():
    files = {
        f"{P}/internal/rbt.py": "def butterfly(a):\n    return a\n",
        f"{P}/robust/abft.py": "def tile_check(a):\n    return a, 0\n",
        f"{P}/robust/faults.py": (
            'SITES = ("site_a", "site_b")\n\n\n'
            "def maybe_corrupt(site, x):\n    return x\n"),
        f"{P}/robust/recovery.py": RECOVERY,
        f"{P}/serve/batched.py": BATCHED,
        f"{P}/drivers/blas3.py": """\
            def gemm(a, b):
                ok = resolve_abft(None)
                return a


            def trsm(a, b):
                ok = resolve_abft(None)
                return a
            """,
        f"{P}/drivers/lu.py": (
            "from ..robust import health\n\n\n"
            "def _getrf(a):\n    ok = resolve_abft(None)\n    return a\n\n\n"
            "def getrf(a, opts=None):\n    return health.finalize(a)\n"),
        f"{P}/drivers/cholesky.py": (
            "from ..robust import health\n\n\n"
            "def potrf(a, opts=None):\n    ok = resolve_abft(None)\n"
            "    return health.finalize(a)\n"),
        f"{P}/drivers/mixed.py": (
            "from ..robust import health\n\n\n"
            "def gesv_mixed(a, opts=None):\n"
            "    spec = resolve_speculate(opts)\n"
            "    return health.finalize(a)\n"),
    }
    for name in ("band.py", "qr.py", "heev.py", "svd.py", "stedc.py",
                 "hetrf.py", "inverse.py", "condest.py"):
        files[f"{P}/drivers/{name}"] = _driver(name[:-3])
    return files


def _with_header(head, body):
    return "from ..robust import health\n" + head + "\n\n" + body


# (rule, file, source, what the message must hold): each mutation of the
# skeleton fires exactly its rule
SEAM_FIRES = {
    "SEAM001-no-opts": (
        "SEAM001", "drivers/qr.py",
        _driver("qr") + "\n\ndef geqrf(a):\n    return a\n",
        "public driver `geqrf` does not accept `opts`"),
    "SEAM002-no-robust-import": (
        "SEAM002", "drivers/band.py",
        "def band(a, opts=None):\n    return a\n",
        "does not import the robust layer"),
    "SEAM003-no-health-reference": (
        "SEAM003", "drivers/band.py",
        "from ..robust import health\n\n\n"
        "def band(a, opts=None):\n    return a\n",
        "never touches the health machinery"),
    "SEAM004-rbt-policy-import": (
        "SEAM004", "internal/rbt.py",
        "from ..robust import recovery\n\n\n"
        "def butterfly(a):\n    return a\n",
        "butterfly mechanism must stay policy-free"),
    "SEAM005-double-resolve": (
        "SEAM005", "robust/recovery.py",
        textwrap.dedent(RECOVERY).replace(
            "    spec = resolve_speculate(opts)\n    ab = resolve_abft(opts)\n",
            "    spec = resolve_speculate(opts)\n"
            "    spec = resolve_speculate(opts)\n"
            "    ab = resolve_abft(opts)\n", 1),
        "resolve_speculate 2x"),
    "SEAM005-missing-escalation": (
        "SEAM005", "robust/recovery.py",
        textwrap.dedent(RECOVERY).replace(
            "    spec = resolve_speculate(opts)\n    r = bounded_retry(a)\n",
            "    spec = resolve_speculate(opts)\n    r = a\n", 1),
        "never routes through bounded_retry"),
    "SEAM006-speculate-knob": (
        "SEAM006", "drivers/svd.py",
        _driver("svd") + "\n\ndef peek(a, opts=None):\n"
                         "    return Option.Speculate\n",
        "reads Option.Speculate directly"),
    "SEAM007-abft-raise": (
        "SEAM007", "robust/abft.py",
        "def tile_check(a):\n    raise ValueError('detected')\n",
        "detection is DATA"),
    "SEAM008-double-resolve-abft": (
        "SEAM008", "drivers/cholesky.py",
        "from ..robust import health\n\n\n"
        "def potrf(a, opts=None):\n"
        "    ok = resolve_abft(None)\n    ok = resolve_abft(None)\n"
        "    return health.finalize(a)\n",
        "resolve_abft 2x"),
    "SEAM009-unknown-site": (
        "SEAM009", "drivers/band.py",
        _driver("band") + "\n\ndef inject(a, opts=None):\n"
                          "    return maybe_corrupt('not_a_site', a)\n",
        "'not_a_site' not in faults.SITES"),
    "SEAM009-computed-site": (
        "SEAM009", "drivers/band.py",
        _driver("band") + "\n\ndef inject(a, s, opts=None):\n"
                          "    return faults.maybe_corrupt(s + '_x', a)\n",
        "not a string literal"),
    "SEAM009-forwarder-variable-site": (
        "SEAM009", "drivers/cholesky.py",
        "from ..robust import health, faults\n\n\n"
        "def _corrupt_storage(site, st):\n"
        "    return faults.maybe_corrupt(site, st)\n\n\n"
        "def potrf(a, opts=None):\n"
        "    ok = resolve_abft(None)\n"
        "    where = 'site_' + 'a'\n"
        "    a = _corrupt_storage(where, a)\n"
        "    return health.finalize(a)\n",
        "_corrupt_storage site is not a string literal"),
    "SEAM009-forwarder-unknown-site": (
        "SEAM009", "drivers/cholesky.py",
        "from ..robust import health, faults\n\n\n"
        "def _corrupt_storage(site, st):\n"
        "    return faults.maybe_corrupt(site, st)\n\n\n"
        "def potrf(a, opts=None):\n"
        "    ok = resolve_abft(None)\n"
        "    a = _corrupt_storage('post_nowhere', a)\n"
        "    return health.finalize(a)\n",
        "_corrupt_storage site 'post_nowhere' not in faults.SITES"),
    "SEAM009-two-level-forwarder": (
        "SEAM009", "drivers/cholesky.py",
        "from ..robust import health, faults\n\n\n"
        "def _strike(st, site):\n"
        "    return faults.maybe_corrupt(site, st)\n\n\n"
        "def _corrupt_storage(where, st):\n"
        "    return _strike(st, site=where)\n\n\n"
        "def potrf(a, opts=None):\n"
        "    ok = resolve_abft(None)\n"
        "    return health.finalize(_corrupt_storage('post_nowhere', a))\n",
        "_corrupt_storage site 'post_nowhere' not in faults.SITES"),
    "SEAM010-abft-knob": (
        "SEAM010", "drivers/hetrf.py",
        _driver("hetrf") + "\n\ndef peek(a, opts=None):\n"
                           "    return Option.Abft\n",
        "reads Option.Abft directly"),
    "SEAM011-raw-plan-cache": (
        "SEAM011", "drivers/qr.py",
        _with_header("from ..tune.plans import load_cache\n",
                     "def qr(a, opts=None):\n    plans = load_cache()\n"
                     "    return health.finalize(a)\n"),
        "load_cache"),
    "SEAM012-cudagraph-in-server": (
        "SEAM012", "serve/server.py",
        "import torch\n\n\ndef run(fn, a):\n"
        "    g = torch.cuda.CUDAGraph()\n    return g\n",
        "`CUDAGraph`"),
    "SEAM012-cuda-graph-context": (
        "SEAM012", "serve/server.py",
        "import torch\n\n\ndef run(fn, g, a):\n"
        "    with torch.cuda.graph(g):\n        return fn(a)\n",
        "torch.cuda.graph"),
    "SEAM012-captured-in-pool": (
        "SEAM012", "serve/pool.py",
        "from ..internal.graphs import Captured\n\n\n"
        "def warm(fn, a):\n    return Captured(fn, (a,))\n",
        "`Captured`"),
    "SEAM012-torch-compile": (
        "SEAM012", "serve/batched.py",
        textwrap.dedent(BATCHED) + "\n\ndef fast(fn):\n"
                                   "    import torch\n"
                                   "    return torch.compile(fn)\n",
        "`compile`"),
    "SEAM013-raw-checkpoint-io": (
        "SEAM013", "drivers/lu.py",
        "from ..robust import health\n"
        "from ..robust.checkpoint import write_payload\n\n\n"
        "def _getrf(a):\n    ok = resolve_abft(None)\n    return a\n\n\n"
        "def getrf(a, opts=None):\n"
        "    write_payload('p', {}, {})\n"
        "    return health.finalize(a)\n",
        "write_payload"),
    "SEAM014-to-bfloat16": (
        "SEAM014", "drivers/qr.py",
        _with_header("import torch\n",
                     "def qr(a, opts=None):\n"
                     "    low = a.to(torch.bfloat16)\n"
                     "    return health.finalize(low)\n"),
        "`bfloat16`"),
    "SEAM014-to-device-and-half": (
        "SEAM014", "drivers/qr.py",
        _with_header("import torch\n",
                     "def qr(a, opts=None):\n"
                     "    low = a.to(a.device, torch.half)\n"
                     "    return health.finalize(low)\n"),
        "`half`"),
    "SEAM014-type-float16": (
        "SEAM014", "drivers/qr.py",
        _with_header("import torch\n",
                     "def qr(a, opts=None):\n"
                     "    low = a.type(torch.float16)\n"
                     "    return health.finalize(low)\n"),
        "`float16`"),
    "SEAM014-half-method": (
        "SEAM014", "drivers/qr.py",
        _with_header("", "def qr(a, opts=None):\n"
                         "    return health.finalize(a.half())\n"),
        "`half`"),
    "SEAM014-dtype-kwarg-in-serve": (
        "SEAM014", "serve/server.py",
        "import torch\n\n\ndef pack(n):\n"
        "    return torch.zeros((n, n), dtype='bf16')\n",
        "`bf16`"),
    "SEAM014-constructed-not-raised": (
        "SEAM014", "drivers/mixed.py",
        "from ..robust import health\n\n\n"
        "def gesv_mixed(a, opts=None):\n"
        "    spec = resolve_speculate(opts)\n"
        "    err = SlateUnsupportedDtypeError('no', dtype='bfloat16')\n"
        "    return health.finalize(a)\n",
        "`bfloat16`"),
    "SEAM014-raw-precision-knob": (
        "SEAM014", "drivers/hetrf.py",
        _driver("hetrf") + "\n\ndef peek(a, opts=None):\n"
                           "    return opts.get(Option.Precision)\n",
        "reads Option.Precision directly"),
    "SEAM014-double-resolve-precision": (
        "SEAM014", "serve/batched.py",
        textwrap.dedent(BATCHED).replace(
            "    low = resolve_precision(opts)\n",
            "    low = resolve_precision(opts)\n"
            "    low2 = resolve_precision(opts)\n", 1),
        "`batch_program` calls resolve_precision 2x"),
    "SEAM014-boundary-missing": (
        "SEAM014", "serve/batched.py",
        "def make_batched(op, opts=None):\n"
        "    low = resolve_precision(opts)\n    return op\n",
        "precision boundary `batch_program` not found"),
}


@pytest.mark.parametrize("case", sorted(SEAM_FIRES))
def test_seam_rule_fires(tmp_path, case):
    rule, rel, src, text = SEAM_FIRES[case]
    files = seam_skeleton()
    files[f"{P}/{rel}"] = src
    fs = lint(mini_repo(tmp_path, files), SEAM_IDS)
    assert rule_ids(fs) == {rule}, [f.render() for f in fs]
    assert any(text in f.message for f in fs), [f.message for f in fs]


# compliant twins: each edit of the skeleton stays clean
SEAM_SILENT = {
    "skeleton": {},
    "SEAM001-exempt-name": {
        "drivers/qr.py": _driver("qr") + "\n\ndef norm1est(a):\n    return a\n"},
    "SEAM001-private-helper": {
        "drivers/heev.py": _driver("heev") +
        "\n\ndef _library_call(fn, x):\n    return fn(x)\n"},
    "SEAM009-vocabulary-site": {
        "drivers/band.py": _driver("band") +
        "\n\ndef inject(a, opts=None):\n"
        "    return maybe_corrupt('site_a', a)\n"},
    "SEAM009-forwarder-literal-sites": {
        "drivers/cholesky.py":
        "from ..robust import health, faults\n\n\n"
        "def _corrupt_storage(site, st):\n"
        "    if faults.active(site) is None:\n"
        "        return faults.maybe_corrupt(site, st)\n"
        "    return faults.maybe_corrupt(site, st)\n\n\n"
        "def potrf(a, opts=None):\n"
        "    ok = resolve_abft(None)\n"
        "    a = _corrupt_storage('site_a', a)\n"
        "    return health.finalize(_corrupt_storage(site='site_b', "
        "st=a))\n"},
    "SEAM011-resolver-and-tune": {
        "tune/plans.py": "def load_cache():\n    return {}\n\n\n"
                         "def resolve_plan(op, n, dtype='float32'):\n"
                         "    return load_cache().get(op)\n",
        "drivers/qr.py": _with_header(
            "from ..tune.plans import resolve_plan\n",
            "def qr(a, opts=None):\n"
            "    plan = resolve_plan('geqrf_panel', 128)\n"
            "    return health.finalize(a)\n")},
    "SEAM012-cache-captures-server-asks": {
        "serve/cache.py": "import torch\n"
                          "from ..internal.graphs import Captured\n\n\n"
                          "def get_or_compile(fn, a):\n"
                          "    g = torch.cuda.CUDAGraph()\n"
                          "    return Captured(fn, (a,))\n",
        "serve/server.py": "from .cache import get_or_compile\n\n\n"
                           "def run(fn, a):\n"
                           "    exe = get_or_compile(fn, a)\n"
                           "    return exe(a)\n"},
    "SEAM013-manager": {
        "robust/checkpoint.py": "def write_payload(path, header, arrays):\n"
                                "    return 'sha', 0\n\n\n"
                                "class CheckpointManager:\n"
                                "    def save(self, op, step, m):\n"
                                "        return write_payload('p', {}, {})\n",
        "drivers/lu.py": "from ..robust import health\n\n\n"
                         "def _getrf(a):\n    ok = resolve_abft(None)\n"
                         "    return a\n\n\n"
                         "def getrf(a, opts=None, checkpoint=None):\n"
                         "    if checkpoint is not None:\n"
                         "        checkpoint.save('getrf', 0, a)\n"
                         "    return health.finalize(a)\n"},
    "SEAM014-high-casts-and-raised-dtype": {
        "drivers/qr.py": _with_header(
            "import torch\n",
            "def qr(a, opts=None):\n"
            "    up = a.to(torch.float32)\n"
            "    moved = up.to(a.device)\n"
            "    z = torch.zeros(4, dtype=torch.float64)\n"
            "    if a.dtype == torch.bfloat16:\n"
            "        raise SlateUnsupportedDtypeError('no bf16 factor',\n"
            "                                         dtype='bfloat16')\n"
            "    return health.finalize(moved)\n"),
        "robust/precision.py": "import torch\n\n\n"
                               "def demote(x):\n"
                               "    return x.to(torch.bfloat16)\n\n\n"
                               "def resolve_precision(opts):\n"
                               "    return bool(opts and "
                               "opts.get(Option.Precision))\n"},
}


@pytest.mark.parametrize("case", sorted(SEAM_SILENT))
def test_seam_rule_silent(tmp_path, case):
    files = seam_skeleton()
    files.update({f"{P}/{rel}": src
                  for rel, src in SEAM_SILENT[case].items()})
    assert lint(mini_repo(tmp_path, files), SEAM_IDS) == []


def test_every_seam_rule_has_a_firing_fixture():
    assert {rule for rule, *_ in SEAM_FIRES.values()} == SEAM_IDS


# --------------------------------------------------------------------------
# observability pack (OBS001, OBS002)


def test_obs001_fires_on_adhoc_telemetry(tmp_path):
    root = mini_repo(tmp_path, {
        f"{P}/drivers/qr.py": ("def qr(a, opts=None):\n"
                               "    print('factoring', a)\n"
                               "    return a\n"),
        f"{P}/internal/gemm.py": ("import logging\n\n"
                                  "log = logging.getLogger(__name__)\n"),
        f"{P}/parallel/dist_lu.py": ("def dist_getrf(a, debug):\n"
                                     "    debug.print(a)\n"
                                     "    return a\n"),
    })
    fs = lint(root, {"OBS001"})
    assert rule_ids(fs) == {"OBS001"}
    assert {f.path for f in fs} == {f"{P}/drivers/qr.py",
                                    f"{P}/internal/gemm.py",
                                    f"{P}/parallel/dist_lu.py"}


def test_obs001_silent_on_obs_spine_and_printing(tmp_path):
    root = mini_repo(tmp_path, {
        f"{P}/drivers/qr.py": ("from ..util.trace import annotate, span\n\n\n"
                               "@annotate('slate.geqrf')\n"
                               "def geqrf(a, opts=None):\n"
                               "    with span('slate.geqrf/panel'):\n"
                               "        return a\n"),
        f"{P}/drivers/printing.py": "def pprint(a):\n    print(a)\n",
        f"{P}/obs/events.py": "def emit(line):\n    print(line)\n",
        f"{P}/tester.py": "def main():\n    print('pass')\n",
    })
    assert lint(root, {"OBS001"}) == []


FLOPS_FIXTURE = """\
    def register(*names):
        def deco(fn):
            return fn
        return deco


    @register("gesv", "posv")
    def _f(shapes, sizes):
        return 1.0
    """


def _annotated(op, fn, tail=""):
    return ("from ..util.trace import annotate\n\n\n"
            f"@annotate('slate.{op}'){tail}\n"
            f"def {fn}(a, opts=None):\n    return a\n")


def test_obs002_fires_on_unpriced_driver(tmp_path):
    root = mini_repo(tmp_path, {
        f"{P}/obs/flops.py": FLOPS_FIXTURE,
        f"{P}/drivers/qr.py": _annotated("geqrf", "geqrf")})
    (f,) = lint(root, {"OBS002"})
    assert f.rule == "OBS002" and f.path == f"{P}/drivers/qr.py"
    assert f.line == 4 and "geqrf" in f.message


def test_obs002_silent_on_registered_or_disabled(tmp_path):
    root = mini_repo(tmp_path, {
        f"{P}/obs/flops.py": FLOPS_FIXTURE,
        f"{P}/drivers/lu.py": _annotated("gesv", "gesv"),
        f"{P}/drivers/band.py": _annotated(
            "pbsv", "pbsv", "  # slate-lint: disable=OBS002 -- band cost "
                            "needs kl/ku, not recoverable from event shapes"),
    })
    assert lint(root, {"OBS002"}) == []


def test_obs002_silent_without_flops_module(tmp_path):
    root = mini_repo(tmp_path, {f"{P}/drivers/qr.py":
                                _annotated("geqrf", "geqrf")})
    assert lint(root, {"OBS002"}) == []


# --------------------------------------------------------------------------
# lock-discipline pack (CON001-CON003)


EVENTS_FIXTURE_HEADER = """\
import threading

_LOCK = threading.Lock()
_CFG = {"enabled": False}
_RING = []
_COLLECTORS = []


"""

ADMISSION_FIXTURE = """\
import threading


class AdmissionQueue:
    def __init__(self):
        self._lock = threading.Condition()
        self._items = []
        self._shed = 0
        self._closed = None

    def depth(self):
        with self._lock:
            return len(self._items)
"""

POOL_FIXTURE = """\
import threading


class DevicePool:
    def __init__(self, devices):
        self._lock = threading.Lock()
        self._members = list(devices)
        self._rr = 0
        self._failovers = 0
        self._quarantines = 0
        self._readmissions = 0
"""

PLANS_FIXTURE = """\
import threading

_LOCK = threading.Lock()
_CACHE = None
_CACHE_KEY = None
_MEMO = {}


"""

KERNELS_FIXTURE = """\
import subprocess
import threading


class CudaKernel:
    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
"""

# (file, source, the guarded name the finding names): each fires CON001
CON001_FIRES = {
    "events-module-state": (
        "obs/events.py", EVENTS_FIXTURE_HEADER +
        "def toggle(on):\n    _CFG['enabled'] = on\n", "_CFG"),
    "admission-queue": (
        "serve/admission.py", ADMISSION_FIXTURE +
        "\n    def sneak(self):\n        self._shed += 1\n", "_shed"),
    "pool-rotation": (
        "serve/pool.py", POOL_FIXTURE +
        "\n    def select(self):\n        m = self._members[self._rr]\n"
        "        self._rr += 1\n        return m\n", "_rr"),
    "plan-memo": (
        "tune/plans.py", PLANS_FIXTURE +
        "def resolve(key):\n    return _MEMO.get(key)\n", "_MEMO"),
    "kernel-library": (
        "internal/kernels.py", KERNELS_FIXTURE +
        "\n    def lib(self):\n        return self._lib\n", "_lib"),
    "peek-in-a-nested-def": (
        "obs/events.py", EVENTS_FIXTURE_HEADER +
        "def later():\n    with _LOCK:\n        def f():\n"
        "            return _RING[-1]\n    return f\n", "_RING"),
}

CON001_SILENT = {
    "events-locked-or-suppressed": (
        "obs/events.py", EVENTS_FIXTURE_HEADER +
        "def toggle(on):\n    with _LOCK:\n        _CFG['enabled'] = on\n\n\n"
        "def peek():\n"
        "    # slate-lint: disable=CON001 -- lock-free fast-path peek\n"
        "    return _CFG['enabled']\n"),
    "admission-queue": (
        "serve/admission.py", ADMISSION_FIXTURE +
        "\n    def sneak(self):\n        with self._lock:\n"
        "            self._shed += 1\n"),
    "pool-rotation": (
        "serve/pool.py", POOL_FIXTURE +
        "\n    def select(self):\n        with self._lock:\n"
        "            m = self._members[self._rr]\n"
        "            self._rr += 1\n        return m\n"),
    "plan-memo": (
        "tune/plans.py", PLANS_FIXTURE +
        "def resolve(key):\n    with _LOCK:\n        return _MEMO.get(key)\n"),
    "kernel-library": (
        "internal/kernels.py", KERNELS_FIXTURE +
        "\n    def lib(self):\n        with self._lock:\n"
        "            return self._lib\n"),
}


@pytest.mark.parametrize("case", sorted(CON001_FIRES))
def test_con001_fires(tmp_path, case):
    rel, src, name = CON001_FIRES[case]
    fs = lint(mini_repo(tmp_path, {f"{P}/{rel}": src}), {"CON001"})
    assert fs and rule_ids(fs) == {"CON001"}
    assert any(f"`{name}`" in f.message for f in fs)


@pytest.mark.parametrize("case", sorted(CON001_SILENT))
def test_con001_silent(tmp_path, case):
    rel, src = CON001_SILENT[case]
    assert lint(mini_repo(tmp_path, {f"{P}/{rel}": src}), {"CON001"}) == []


TWO_LOCKS = (con.LockSpec(f"{P}/a.py", None, "_LA", ("_SA",)),
             con.LockSpec(f"{P}/b.py", None, "_LB", ("_SB",)))


def _lock_module(mine, other, body):
    return (f"import threading\nfrom . import {other}\n\n"
            f"_L{mine.upper()} = threading.Lock()\n"
            f"_S{mine.upper()} = []\n\n\n"
            f"def take_{mine}():\n    with _L{mine.upper()}:\n"
            f"        _S{mine.upper()}.append(1)\n\n\n" + body)


def test_con002_fires_on_lock_order_inversion(tmp_path, monkeypatch):
    monkeypatch.setattr(con, "LOCK_REGISTRY", TWO_LOCKS)
    root = mini_repo(tmp_path, {
        f"{P}/a.py": _lock_module("a", "b", "def cross():\n    with _LA:\n"
                                            "        b.take_b()\n"),
        f"{P}/b.py": _lock_module("b", "a", "def cross():\n    with _LB:\n"
                                            "        a.take_a()\n"),
    })
    fs = lint(root, {"CON002"})
    assert [f.rule for f in fs] == ["CON002"]
    assert "inversion" in fs[0].message


def test_con002_silent_on_consistent_order(tmp_path, monkeypatch):
    monkeypatch.setattr(con, "LOCK_REGISTRY", TWO_LOCKS)
    root = mini_repo(tmp_path, {
        f"{P}/a.py": _lock_module("a", "b", "def cross():\n    with _LA:\n"
                                            "        b.take_b()\n"),
        f"{P}/b.py": _lock_module("b", "a", ""),
    })
    assert lint(root, {"CON002"}) == []


def test_con002_fires_on_self_reacquire(tmp_path):
    root = mini_repo(tmp_path, {
        f"{P}/obs/events.py": EVENTS_FIXTURE_HEADER +
        "def set_on():\n    with _LOCK:\n        _CFG['enabled'] = True\n\n\n"
        "def flip():\n    with _LOCK:\n        set_on()\n"})
    fs = lint(root, {"CON002"})
    assert [f.rule for f in fs] == ["CON002"]
    assert "re-acquires" in fs[0].message


CACHE_FIXTURE = """\
import threading
import time

import torch


class ExecutableCache:
    def __init__(self):
        self._lock = threading.Lock()
        self._exes = {}

    def get(self, key, fn):
        with self._lock:
            exe = self._exes.get(key)
"""

GRAPHS_FIXTURE = """\
import threading

import torch

_CAPTURE_LOCK = threading.Lock()


class Captured:
    def __init__(self, fn):
        with _CAPTURE_LOCK:
{line}

    def _capture(self, fn):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin()
        fn()
        self.graph.capture_end()
"""

# (file, source, what the finding names): each fires CON003
CON003_FIRES = {
    "device-sync": (
        "serve/cache.py",
        CACHE_FIXTURE + "            torch.cuda.synchronize()\n"
                        "        return exe\n", "synchronize"),
    "stream-sync": (
        "serve/cache.py",
        CACHE_FIXTURE + "            torch.cuda.current_stream().synchronize()"
                        "\n        return exe\n", "synchronize"),
    "sleep": (
        "serve/cache.py",
        CACHE_FIXTURE + "            time.sleep(0.1)\n        return exe\n",
        "sleep"),
    "get-or-compile-under-pool-lock": (
        "serve/pool.py",
        POOL_FIXTURE + "\n    def warm(self, cache, op):\n"
                       "        with self._lock:\n"
                       "            for m in self._members:\n"
                       "                cache.get_or_compile(op, device=m)\n",
        "get_or_compile"),
    "capture-through-a-callee": (
        "internal/graphs.py",
        GRAPHS_FIXTURE.format(line="            self._capture(fn)"),
        "Captured._capture -> capture_begin"),
    "captured-under-held-lock": (
        "drivers/cholesky.py",
        "import threading\n\n_HELD_LOCK = threading.Lock()\n_HELD = {}\n\n\n"
        "def held(key, fn, a):\n    with _HELD_LOCK:\n"
        "        _HELD[key] = Captured(fn, (a,))\n", "Captured"),
    "nvcc-under-kernel-lock": (
        "internal/kernels.py",
        KERNELS_FIXTURE + "\n    def lib(self):\n        with self._lock:\n"
                          "            subprocess.run(['nvcc'])\n",
        "subprocess.run"),
}

CON003_SILENT = {
    "sync-outside-the-lock": (
        "serve/cache.py",
        CACHE_FIXTURE + "        torch.cuda.synchronize()\n"
                        "        return exe\n"),
    "capture-suppressed-with-reason": (
        "internal/graphs.py",
        GRAPHS_FIXTURE.format(
            line="            # slate-lint: disable=CON003 -- one capture "
                 "at a time by design\n            self._capture(fn)")),
    "capture-outside-the-lock": (
        "internal/graphs.py",
        GRAPHS_FIXTURE.format(line="            pass\n"
                                   "        self._capture(fn)")),
    "condition-wait-under-its-lock": (
        "serve/admission.py",
        ADMISSION_FIXTURE + "\n    def wait(self, t):\n"
                            "        with self._lock:\n"
                            "            self._lock.wait(t)\n"),
}


@pytest.mark.parametrize("case", sorted(CON003_FIRES))
def test_con003_fires(tmp_path, case):
    rel, src, what = CON003_FIRES[case]
    fs = lint(mini_repo(tmp_path, {f"{P}/{rel}": src}), {"CON003"})
    assert [f.rule for f in fs] == ["CON003"], [f.render() for f in fs]
    assert f"`{what}`" in fs[0].message


@pytest.mark.parametrize("case", sorted(CON003_SILENT))
def test_con003_silent(tmp_path, case):
    rel, src = CON003_SILENT[case]
    assert lint(mini_repo(tmp_path, {f"{P}/{rel}": src}), {"CON003"}) == []


def test_lock_registry_modules_and_guards_exist(port_project):
    """Every registered lock names a module, class and lock of the port,
    and every guarded name appears in that module."""
    for spec in con.LOCK_REGISTRY:
        mod = port_project.module(spec.module)
        assert mod is not None, spec
        owner = "self." if spec.cls else ""
        assert f"{owner}{spec.lock} = threading." in mod.text, spec
        if spec.cls:
            assert f"class {spec.cls}" in mod.text, spec
        for name in spec.guards:
            assert name in mod.text, (spec, name)


# --------------------------------------------------------------------------
# mutations of the real serving modules


def _mutation(tmp_path, rel, locked, unlocked):
    real = (REPO / P / rel).read_text()
    good = mini_repo(tmp_path / "good", {f"{P}/{rel}": real})
    assert lint(good, {"CON001"}) == []
    assert locked in real
    bad = mini_repo(tmp_path / "bad",
                    {f"{P}/{rel}": real.replace(locked, unlocked, 1)})
    return lint(bad, {"CON001"})


def test_con001_mutation_of_real_server_is_caught(tmp_path):
    """Drop the first `with self._lock:` of the real Server: CON001 fires
    on its guarded state; the pristine text stays clean."""
    fs = _mutation(tmp_path, "serve/server.py", "with self._lock:",
                   "if True:")
    assert fs and rule_ids(fs) == {"CON001"}
    guards = next(s.guards for s in con.LOCK_REGISTRY if s.cls == "Server")
    assert all(any(f"`{g}`" in f.message for g in guards) for f in fs)


def test_con001_mutation_of_real_admission_queue_is_caught(tmp_path):
    """Unlock take_all()'s item swap in the real AdmissionQueue: CON001
    fires on the queue's items."""
    fs = _mutation(
        tmp_path, "serve/admission.py",
        "        with self._lock:\n"
        "            items, self._items = self._items, []",
        "        if True:\n"
        "            items, self._items = self._items, []")
    assert fs and rule_ids(fs) == {"CON001"}
    assert all("`_items`" in f.message for f in fs)


@pytest.mark.parametrize("rel,cls", [("serve/pool.py", "DevicePool"),
                                     ("core/storage.py", "TileMap"),
                                     ("robust/checkpoint.py",
                                      "CheckpointManager")])
def test_con001_mutation_of_other_real_locks_is_caught(tmp_path, rel, cls):
    fs = _mutation(tmp_path, rel, "with self._lock:", "if True:")
    assert fs and rule_ids(fs) == {"CON001"}
    guards = next(s.guards for s in con.LOCK_REGISTRY if s.cls == cls)
    assert all(any(f"`{g}`" in f.message for g in guards) for f in fs)


# --------------------------------------------------------------------------
# suppressions and the command line


def test_suppression_parsing_units():
    sup = parse_suppressions([
        (3, "# slate-lint: disable=CON001,OBS002 -- why", False),
        (7, "# slate-lint: disable=all", True),
    ])
    assert sup[3] == {"CON001", "OBS002"}
    assert sup[7] == {"all"} and sup[8] == {"all"}


def test_cli_exit_codes(tmp_path, capsys):
    clean = mini_repo(tmp_path / "clean", {
        **seam_skeleton(), f"{P}/obs/flops.py": FLOPS_FIXTURE,
        f"{P}/drivers/auxiliary.py": _annotated("gesv", "gesv")})
    dirty = mini_repo(tmp_path / "dirty", {
        **seam_skeleton(), f"{P}/obs/flops.py": FLOPS_FIXTURE,
        f"{P}/drivers/auxiliary.py": _annotated("geqrf", "geqrf")})
    assert cli.main(["--root", str(clean)]) == 0
    assert "slate-lint OK" in capsys.readouterr().out
    assert cli.main(["--root", str(dirty), "--select", "OBS002"]) == 1
    assert "OBS002" in capsys.readouterr().out
    assert cli.main(["--root", str(dirty), "--format", "json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in report["findings"]] == ["OBS002"]
    assert report["rules"] == sorted(PACK_IDS)
    assert cli.main(["--root", str(clean), "--select", "TRC001"]) == 2
    assert cli.main(["--root", str(tmp_path / "nowhere")]) == 2
    assert cli.main(["--no-such-flag"]) == 2
    capsys.readouterr()


def test_cli_list_rules(capsys):
    assert cli.main(["--list-rules"]) == 0
    listed = [line.split()[0] for line in
              capsys.readouterr().out.splitlines()]
    assert listed == sorted(PACK_IDS)


def test_module_entry_point(tmp_path):
    """``python -m slate_tpu_torch.lint`` on a mini tree with one
    unregistered @annotate op: OBS002 and exit 1."""
    root = mini_repo(tmp_path, {
        f"{P}/obs/flops.py": FLOPS_FIXTURE,
        f"{P}/drivers/qr.py": _annotated("geqrf", "geqrf")})
    res = subprocess.run(
        [sys.executable, "-m", "slate_tpu_torch.lint", "--root", str(root),
         "--select", "OBS001,OBS002"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1, res.stderr
    assert f"{P}/drivers/qr.py:4: OBS002" in res.stdout
