"""Policy-seam rules (SEAM0xx): the drivers' robustness contract
(docs/ROBUSTNESS.md), restated for the port (port of
tools/slate_lint/rules/seams.py).

====== ===============================================================
SEAM001 public drivers accept ``opts``
SEAM002 checked driver modules import the robust layer
SEAM003 ... and actually reference the health machinery
SEAM004 internal/rbt.py stays policy-free
SEAM005 speculative boundaries resolve_speculate exactly once; recovery
        boundaries route bounded_retry + one finalize
SEAM006 Option.Speculate never read in a driver module
SEAM007 robust/abft.py policy-free and raise-free
SEAM008 ABFT boundaries resolve_abft exactly once
SEAM009 maybe_corrupt sites are literals from faults.SITES; a function
        that hands one of its parameters to maybe_corrupt as the site (a
        site forwarder, e.g. drivers/cholesky.py ``_corrupt_storage``)
        is held to the same rule at each of its calls
SEAM010 Option.Abft never read in a driver module
SEAM011 the raw plan cache (load_cache / save_cache / cache_path /
        record_plan) is only touched inside slate_tpu_torch/tune/;
        everything else goes through resolve_plan
SEAM012 serve/ makes CUDA graphs ONLY through serve/cache.py, the
        counterpart of the reference's "compiles only through the
        executable cache": no ``torch.cuda.CUDAGraph`` /
        ``torch.cuda.graph`` / ``capture_begin`` / internal/graphs
        ``Captured`` (and no ``torch.compile`` / ``torch.jit``) anywhere
        else in serve/, so every capture is counted in
        ExecutableCache.stats and in the serving events
SEAM013 checkpoint serialization (write_payload / read_payload /
        write_manifest / read_manifest) is only touched inside
        robust/checkpoint.py; everything else goes through
        CheckpointManager
SEAM014 mixed precision is a certified policy, not an ambient cast:
        (a) no literal low-precision spelling (torch.bfloat16,
        torch.float16, torch.half, "bf16", ...) reaches ``.to(...)``,
        ``.type(...)``, ``.astype(...)``, a ``dtype=`` keyword or a
        ``.half()`` / ``.bfloat16()`` cast inside drivers/ or serve/ —
        storage-precision changes go through robust/precision.py.  The
        exception raised to refuse a dtype is not a cast: a ``dtype=``
        field of a ``raise``'s exception is skipped.  (b) the raw
        ``Option.Precision`` knob is read only inside robust/precision.py
        and options.py; (c) the precision boundaries call
        resolve_precision EXACTLY once
====== ===============================================================
"""

from __future__ import annotations

import ast

from ..model import Finding, Rule, register

PKG = "slate_tpu_torch"

# ---- configuration: the reference's tables at the port's paths ----------

DRIVERS_DIR = f"{PKG}/drivers"

CHECKED_MODULES = (
    "lu.py", "cholesky.py", "band.py", "mixed.py", "qr.py",
    "heev.py", "svd.py", "stedc.py", "hetrf.py", "inverse.py",
    "condest.py",
)

#: public names of checked modules that are not drivers: the condition-
#: number estimator's kernel and the divide-and-conquer info helper (the
#: reference also exempts its pytree hooks and uplo helpers, which the
#: port's driver modules do not define)
EXEMPT = {"norm1est", "stedc_info"}

HEALTH_NAMES = {"finalize", "finalize_flat", "error_policy", "HealthInfo",
                "from_pivots", "from_result"}

RECOVERY_MODULE = f"{PKG}/robust/recovery.py"
SPECULATIVE_BOUNDARIES = (
    (RECOVERY_MODULE,
     ("gesv_with_recovery", "gels_with_recovery", "hesv_with_recovery",
      "posv_with_recovery")),
    (f"{DRIVERS_DIR}/mixed.py", ("gesv_mixed",)),
)
RECOVERY_BOUNDARIES = {"gesv_with_recovery", "gels_with_recovery",
                       "hesv_with_recovery", "posv_with_recovery"}
RBT_MODULE = f"{PKG}/internal/rbt.py"
FINALIZE_NAMES = {"finalize", "_finalize_solve"}

TUNE_DIR = f"{PKG}/tune"
#: raw plan-cache accessors: consuming code must use resolve_plan instead,
#: so a cache-format change (or a corrupt cache file) has ONE blast radius
RAW_PLAN_CACHE_NAMES = {"load_cache", "save_cache", "cache_path",
                        "record_plan"}

SERVE_DIR = f"{PKG}/serve"
SERVE_CACHE_MODULE = f"{SERVE_DIR}/cache.py"
#: capture- and compile-producing names banned outside the serve cache:
#: the CUDA-graph constructs, internal/graphs.py's Captured, and
#: torch.compile / torch.jit (``torch.cuda.graph`` is matched as the
#: attribute chain ``cuda.graph`` or a ``from torch.cuda import graph``)
SERVE_CAPTURE_NAMES = {"CUDAGraph", "Captured", "capture_begin",
                       "capture_end", "compile", "jit"}

CKPT_MODULE = f"{PKG}/robust/checkpoint.py"
#: raw checkpoint serialization: everyone else uses CheckpointManager,
#: so torn-write semantics and the verify ladder have one blast radius
RAW_CKPT_IO_NAMES = {"write_payload", "read_payload", "write_manifest",
                     "read_manifest"}

PRECISION_MODULE = f"{PKG}/robust/precision.py"
OPTIONS_MODULE = f"{PKG}/options.py"
#: literal low-precision float spellings banned in drivers//serve/ casts
LOW_PRECISION_SPELLINGS = {"bfloat16", "float16", "bf16", "fp16", "half"}
#: methods whose positional arguments name a target dtype
CAST_METHODS = {"to", "type", "astype"}
#: the port's boundaries.  The reference resolves the serving knob in
#: make_batched (slate_tpu/serve/batched.py:521); the port resolves it in
#: batch_program, which builds a bucket's program for both make_batched
#: (the eager callable, which calls it per batch) and serve/cache.py's
#: BucketGraphs (the captured one), so the exactly-once count is held
#: there
PRECISION_BOUNDARIES = (
    (f"{SERVE_DIR}/batched.py", ("batch_program",)),
    (RECOVERY_MODULE, ("posv_with_recovery", "gels_with_recovery")),
)

ABFT_MODULE = f"{PKG}/robust/abft.py"
FAULTS_MODULE = f"{PKG}/robust/faults.py"
ABFT_BOUNDARIES = (
    (f"{DRIVERS_DIR}/lu.py", ("_getrf",)),
    (f"{DRIVERS_DIR}/cholesky.py", ("potrf",)),
    (f"{DRIVERS_DIR}/blas3.py", ("gemm", "trsm")),
    (RECOVERY_MODULE, ("gesv_with_recovery", "posv_with_recovery")),
)

# ---- AST helpers ---------------------------------------------------------


def _call_name(node: ast.Call) -> str | None:
    f = node.func
    return (f.id if isinstance(f, ast.Name)
            else f.attr if isinstance(f, ast.Attribute) else None)


def _public_functions(tree: ast.Module):
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            yield node


def _accepts_opts(fn: ast.FunctionDef) -> bool:
    names = [a.arg for a in fn.args.args + fn.args.kwonlyargs]
    return "opts" in names or fn.args.kwarg is not None


def _imports_robust(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            if "robust" in node.module.split("."):
                return True
        if isinstance(node, ast.Import):
            if any("robust" in alias.name.split(".")
                   for alias in node.names):
                return True
    return False


def _references_health(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in HEALTH_NAMES:
            return True
        if isinstance(node, ast.Name) and node.id in HEALTH_NAMES:
            return True
    return False


def _count_calls(fn: ast.FunctionDef, names: set[str]) -> int:
    return sum(1 for node in ast.walk(fn)
               if isinstance(node, ast.Call) and _call_name(node) in names)


def _top_defs(mod) -> dict[str, ast.FunctionDef]:
    return {n.name: n for n in mod.tree.body
            if isinstance(n, ast.FunctionDef)}


def _fault_sites(project) -> set[str]:
    mod = project.module(FAULTS_MODULE)
    if mod is None:
        return set()
    for node in mod.tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets
                       if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            targets = [node.target.id]
        if "SITES" in targets and node.value is not None:
            return {c.value for c in ast.walk(node.value)
                    if isinstance(c, ast.Constant)
                    and isinstance(c.value, str)}
    return set()


def _driver_modules(project):
    """The files directly under drivers/, sorted."""
    return sorted(r for r in project.modules
                  if r.startswith(DRIVERS_DIR + "/")
                  and r.count("/") == DRIVERS_DIR.count("/") + 1)


def _package_modules(project):
    """slate_tpu_torch/**/*.py in path-parts order."""
    rels = [r for r in project.modules if r.startswith(PKG + "/")]
    return sorted(rels, key=lambda r: tuple(r.split("/")))


def _names_used(node) -> str | None:
    """The name a node loads or the attribute it reads."""
    if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _scan_names(project, rels, names: set[str], rule_id: str, message):
    """Every load, attribute or import of one of ``names`` in ``rels``."""
    for rel in rels:
        mod = project.modules[rel]
        for node in mod.nodes:
            name = _names_used(node)
            if isinstance(node, (ast.ImportFrom, ast.Import)):
                hits = names.intersection(a.name for a in node.names)
                name = sorted(hits)[0] if hits else None
            if name in names:
                yield Finding(rule_id, rel, node.lineno, message(name))


def _exactly_once(project, boundaries, resolver: str, rule_id: str,
                  what: str):
    """Each boundary function exists and calls ``resolver`` once."""
    for rel, fns in boundaries:
        mod = project.module(rel)
        if mod is None:
            yield Finding(rule_id, rel, 1, f"missing {what} boundary module")
            continue
        defs = _top_defs(mod)
        for fname in fns:
            fn = defs.get(fname)
            if fn is None:
                yield Finding(rule_id, rel, 1,
                              f"{what} boundary `{fname}` not found")
                continue
            n_res = _count_calls(fn, {resolver})
            if n_res != 1:
                yield Finding(
                    rule_id, rel, fn.lineno,
                    f"`{fname}` calls {resolver} {n_res}x — the knob must "
                    f"be resolved EXACTLY once at the boundary")


def _mechanism_purity(project, rel, banned_pkgs, tail, rule_id, *,
                      missing_tail, raise_tail=None):
    """A mechanism module must exist, not import the policy layers, and
    (with ``raise_tail``) never raise."""
    mod = project.module(rel)
    if mod is None:
        yield Finding(rule_id, rel, 1, f"missing {missing_tail}")
        return
    for node in mod.nodes:
        mods = []
        if isinstance(node, ast.ImportFrom) and node.module:
            mods = node.module.split(".")
        elif isinstance(node, ast.Import):
            mods = [s for a in node.names for s in a.name.split(".")]
        if any(p in mods for p in banned_pkgs):
            yield Finding(rule_id, rel, node.lineno, tail)
        if raise_tail and isinstance(node, ast.Raise):
            yield Finding(rule_id, rel, node.lineno, raise_tail)


# ---- the scan ------------------------------------------------------------


def seam_scan(project) -> list[Finding]:
    """Every seam finding (run once per project; each rule takes its own
    id out of it)."""
    if "seam_scan" not in project.cache:
        project.cache["seam_scan"] = [
            *_scan_speculation(project), *_scan_abft(project),
            *_scan_sites(project), *_scan_driver_contract(project),
            *_scan_tune(project), *_scan_serve(project),
            *_scan_checkpoint(project), *_scan_precision(project)]
    return project.cache["seam_scan"]


def _scan_speculation(project):
    # SEAM004: rbt.py stays pure mechanism
    yield from _mechanism_purity(
        project, RBT_MODULE, ("options", "robust"),
        "imports the options/robust layer — the butterfly mechanism must "
        "stay policy-free (the seam is drivers/lu.py + robust/recovery.py)",
        "SEAM004",
        missing_tail="the RBT mechanism module the speculative gesv path "
                     "builds on")
    # SEAM005: boundaries resolve the knob exactly once
    yield from _exactly_once(project, SPECULATIVE_BOUNDARIES,
                             "resolve_speculate", "SEAM005", "speculative")
    for rel, fns in SPECULATIVE_BOUNDARIES:
        mod = project.module(rel)
        defs = _top_defs(mod) if mod is not None else {}
        for fname in RECOVERY_BOUNDARIES.intersection(fns):
            fn = defs.get(fname)
            if fn is None:
                continue
            if _count_calls(fn, {"bounded_retry"}) < 1:
                yield Finding(
                    "SEAM005", rel, fn.lineno,
                    f"`{fname}` never routes through bounded_retry — "
                    f"speculation has no escalation path")
            n_fin = _count_calls(fn, FINALIZE_NAMES)
            if n_fin != 1:
                yield Finding(
                    "SEAM005", rel, fn.lineno,
                    f"`{fname}` finalizes {n_fin}x — the (result, "
                    f"HealthInfo) pair must resolve ErrorPolicy exactly "
                    f"once")
    # SEAM006: the raw knob never leaks into a driver module
    yield from _knob_reads(project, "Speculate", "SEAM006",
                           "resolve_speculate")


def _knob_reads(project, knob: str, rule_id: str, resolver: str):
    for rel in _driver_modules(project):
        for node in project.modules[rel].nodes:
            if isinstance(node, ast.Attribute) and node.attr == knob:
                yield Finding(
                    rule_id, rel, node.lineno,
                    f"reads Option.{knob} directly — drivers consume "
                    f"{resolver}'s boolean, never the raw knob")


def _scan_abft(project):
    # SEAM007: abft.py pure mechanism — no options import, no raises
    yield from _mechanism_purity(
        project, ABFT_MODULE, ("options",),
        "imports the options layer — checksum verification must stay "
        "policy-free (the seam is the driver boundary's resolve_abft)",
        "SEAM007",
        missing_tail="the checksum mechanism module the ABFT layer "
                     "builds on",
        raise_tail="raises — detection is DATA (AbftCounts folded into "
                   "HealthInfo); policy resolution lives at the driver "
                   "boundary")
    if project.module(ABFT_MODULE) is None:
        return  # no boundary checks without the mechanism
    # SEAM008: ABFT boundaries resolve the knob exactly once
    yield from _exactly_once(project, ABFT_BOUNDARIES, "resolve_abft",
                             "SEAM008", "ABFT")
    # SEAM010: the raw knob never leaks into a driver module
    yield from _knob_reads(project, "Abft", "SEAM010", "resolve_abft")


def _params(fn) -> list[str]:
    """Positional parameter names, without a method's self/cls."""
    names = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    return names[1:] if names[:1] in (["self"], ["cls"]) else names


def _site_arg(call: ast.Call, index: int, param: str):
    if index < len(call.args):
        return call.args[index]
    for kw in call.keywords:
        if kw.arg == param:
            return kw.value
    return None


def site_forwarders(project) -> dict[str, tuple[int, str]]:
    """name -> (index, name) of the site parameter, for ``maybe_corrupt``
    and every function that hands one of its own parameters on to a
    forwarder as the site (to a fixed point)."""
    if "site_forwarders" in project.cache:
        return project.cache["site_forwarders"]
    defs = []                       # (def, params, calls in its body)
    for rel in _package_modules(project):
        if rel == FAULTS_MODULE:
            continue
        for node in project.modules[rel].nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                params = _params(node)
                calls = [c for c in ast.walk(node) if isinstance(c, ast.Call)
                         and any(isinstance(a, ast.Name) for a in
                                 (*c.args, *(k.value for k in c.keywords)))]
                if params and calls:
                    defs.append((node, params, calls))
    fwd = {"maybe_corrupt": (0, "site")}
    changed = True
    while changed:
        changed = False
        for fn, params, calls in defs:
            if fn.name in fwd:
                continue
            for call in calls:
                spec = fwd.get(_call_name(call))
                arg = _site_arg(call, *spec) if spec else None
                if isinstance(arg, ast.Name) and arg.id in params:
                    fwd[fn.name] = (params.index(arg.id), arg.id)
                    changed = True
                    break
    project.cache["site_forwarders"] = fwd
    return fwd


def _scan_sites(project):
    # SEAM009: every maybe_corrupt call, and every call of a site
    # forwarder, names a site literal in SITES; the one non-literal site
    # allowed is a forwarder's own site parameter, passed on in its body
    sites = _fault_sites(project)
    if not sites:
        yield Finding("SEAM009", FAULTS_MODULE, 1,
                      "SITES vocabulary not found")
    fwd = site_forwarders(project)
    for rel in _package_modules(project):
        if rel == FAULTS_MODULE:
            continue
        yield from _site_calls(rel, project.modules[rel].tree, None, fwd,
                               sites)


def _site_calls(rel, node, own_param, fwd, sites):
    """Walk ``node`` knowing the enclosing function's own site parameter
    (``own_param``, when that function is a forwarder)."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            spec = fwd.get(child.name)
            mine = spec[1] if spec and child.name != "maybe_corrupt" \
                and spec[1] in _params(child) else None
            yield from _site_calls(rel, child, mine, fwd, sites)
            continue
        if isinstance(child, ast.Call) and _call_name(child) in fwd:
            name = _call_name(child)
            arg = _site_arg(child, *fwd[name])
            if isinstance(arg, ast.Name) and arg.id == own_param:
                pass                      # a forwarder passing its site on
            elif not (isinstance(arg, ast.Constant)
                      and isinstance(arg.value, str)):
                yield Finding(
                    "SEAM009", rel, child.lineno,
                    f"{name} site is not a string literal — sites must be "
                    f"a closed, greppable vocabulary")
            elif sites and arg.value not in sites:
                yield Finding(
                    "SEAM009", rel, child.lineno,
                    f"{name} site {arg.value!r} not in faults.SITES")
        yield from _site_calls(rel, child, own_param, fwd, sites)


def _scan_driver_contract(project):
    # SEAM001-003, per checked module
    for name in CHECKED_MODULES:
        rel = f"{DRIVERS_DIR}/{name}"
        mod = project.module(rel)
        if mod is None:
            yield Finding("SEAM002", rel, 1, "missing driver module")
            continue
        if not _imports_robust(mod.tree):
            yield Finding(
                "SEAM002", rel, 1,
                "does not import the robust layer (health/faults/recovery) "
                "— failures are not routed through Option.ErrorPolicy")
        elif not _references_health(mod.tree):
            yield Finding(
                "SEAM003", rel, 1,
                "imports the robust layer but never touches the health "
                "machinery (finalize/error_policy/HealthInfo) — no policy "
                "is resolved")
        for fn in _public_functions(mod.tree):
            if fn.name not in EXEMPT and not _accepts_opts(fn):
                yield Finding(
                    "SEAM001", rel, fn.lineno,
                    f"public driver `{fn.name}` does not accept `opts` — "
                    f"Option.ErrorPolicy cannot reach it")


def _scan_tune(project):
    # SEAM011: the raw plan cache is tune/'s private substrate
    rels = [r for r in _package_modules(project)
            if not r.startswith(TUNE_DIR + "/")]
    yield from _scan_names(
        project, rels, RAW_PLAN_CACHE_NAMES, "SEAM011",
        lambda name: f"touches the raw plan cache (`{name}`) outside "
                     f"{TUNE_DIR}/ — consume plans via resolve_plan so the "
                     f"cache format has one blast radius")


def _is_cuda_graph(node) -> bool:
    """``torch.cuda.graph`` (any ``<x>.cuda.graph``) or ``from torch.cuda
    import graph``."""
    if isinstance(node, ast.Attribute) and node.attr == "graph":
        v = node.value
        return (isinstance(v, ast.Attribute) and v.attr == "cuda") or \
            (isinstance(v, ast.Name) and v.id == "cuda")
    if isinstance(node, ast.ImportFrom) and node.module == "torch.cuda":
        return any(a.name == "graph" for a in node.names)
    return False


def _scan_serve(project):
    # SEAM012: serve/ captures ONLY through serve/cache.py, where the
    # capture accounting (ExecutableCache.stats, the events' `captures`)
    # lives; a stray capture elsewhere makes graphs no event ever sees
    rels = [r for r in _package_modules(project)
            if r.startswith(SERVE_DIR + "/") and r != SERVE_CACHE_MODULE]

    def message(name):
        return (f"captures or compiles directly (`{name}`) inside serve/ — "
                f"CUDA graphs come ONLY from serve/cache.py "
                f"(ExecutableCache.get_or_compile), where capture "
                f"accounting lives")
    yield from _scan_names(project, rels, SERVE_CAPTURE_NAMES, "SEAM012",
                           message)
    for rel in rels:
        for node in project.modules[rel].nodes:
            if _is_cuda_graph(node):
                yield Finding("SEAM012", rel, node.lineno,
                              message("torch.cuda.graph"))


def _scan_checkpoint(project):
    # SEAM013: checkpoint bytes hit disk ONLY through robust/checkpoint.py
    rels = [r for r in _package_modules(project) if r != CKPT_MODULE]
    yield from _scan_names(
        project, rels, RAW_CKPT_IO_NAMES, "SEAM013",
        lambda name: f"touches raw checkpoint serialization (`{name}`) "
                     f"outside {CKPT_MODULE} — go through "
                     f"CheckpointManager so the on-disk format and verify "
                     f"ladder have one blast radius")


def _spells_low_precision(node) -> str | None:
    """The low-precision spelling a dtype expression carries, if any: a
    string literal ('bfloat16', 'bf16', ...) or a dotted/bare name whose
    last part is one (torch.bfloat16, torch.half, np.float16)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value if node.value.lower() in LOW_PRECISION_SPELLINGS \
            else None
    if isinstance(node, ast.Attribute) and node.attr in \
            LOW_PRECISION_SPELLINGS:
        return node.attr
    if isinstance(node, ast.Name) and node.id in LOW_PRECISION_SPELLINGS:
        return node.id
    return None


def _cast_spellings(node: ast.Call):
    """The low-precision spellings a call casts or allocates to."""
    f = node.func
    exprs = []
    if isinstance(f, ast.Attribute) and f.attr in CAST_METHODS:
        exprs += node.args if f.attr == "to" else node.args[:1]
    exprs += [kw.value for kw in node.keywords if kw.arg == "dtype"]
    out = [s for s in map(_spells_low_precision, exprs) if s is not None]
    if isinstance(f, ast.Attribute) and f.attr in ("bfloat16", "half") \
            and not node.args:
        out.append(f.attr)                # x.bfloat16(), x.half()
    return out


def _scan_precision(project):
    # SEAM014a: no literal low-precision cast in drivers/ or serve/ — the
    # precision seam (robust/precision.py demote/promote/round_through) is
    # the only place storage precision changes.  The exception that
    # refuses a dtype names it in a field, which is no cast.
    for rel in _package_modules(project):
        if not rel.startswith((DRIVERS_DIR + "/", SERVE_DIR + "/")):
            continue
        nodes = project.modules[rel].nodes
        raised = {id(n.exc) for n in nodes
                  if isinstance(n, ast.Raise) and n.exc is not None}
        for node in nodes:
            if not isinstance(node, ast.Call) or id(node) in raised:
                continue
            for spelling in _cast_spellings(node):
                yield Finding(
                    "SEAM014", rel, node.lineno,
                    f"casts to low precision (`{spelling}`) inside "
                    f"drivers//serve/ — storage precision changes only "
                    f"through robust/precision.py (demote/promote/"
                    f"round_through), where the f32-accumulation "
                    f"contract lives")
    # SEAM014b: the raw knob is read only inside the seam and its enum
    # definition (exact match on the `Option` base name)
    for rel in _package_modules(project):
        if rel in (PRECISION_MODULE, OPTIONS_MODULE):
            continue
        for node in project.modules[rel].nodes:
            if (isinstance(node, ast.Attribute)
                    and node.attr == "Precision"
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "Option"):
                yield Finding(
                    "SEAM014", rel, node.lineno,
                    "reads Option.Precision directly — boundaries consume "
                    "resolve_precision's boolean (resolved exactly once), "
                    "never the raw knob")
    # SEAM014c: precision boundaries resolve the knob exactly once
    yield from _exactly_once(project, PRECISION_BOUNDARIES,
                             "resolve_precision", "SEAM014", "precision")


class _SeamRule(Rule):
    def run(self, project):
        for finding in seam_scan(project):
            if finding.rule == self.id:
                yield finding


def _make(rule_id: str, text: str) -> None:
    register(type(f"Seam{rule_id[-3:]}", (_SeamRule,),
                  {"id": rule_id, "summary": text}))


_make("SEAM001", "public factor/solve drivers accept `opts` — "
      "Option.ErrorPolicy must be routable to every entry point")
_make("SEAM002", "checked driver modules import the robust layer "
      "(health/faults/recovery)")
_make("SEAM003", "checked driver modules reference the health machinery "
      "— an import alone is not a contract")
_make("SEAM004", "internal/rbt.py stays pure mechanism (no options/robust "
      "imports)")
_make("SEAM005", "speculative boundaries resolve_speculate exactly once; "
      "recovery boundaries route bounded_retry + finalize once")
_make("SEAM006", "no driver module reads the raw Option.Speculate knob")
_make("SEAM007", "robust/abft.py stays pure mechanism: no options import, "
      "no raise — detection is data")
_make("SEAM008", "ABFT boundaries resolve_abft exactly once")
_make("SEAM009", "maybe_corrupt sites (and the sites handed to a site "
      "forwarder) are string literals from faults.SITES — a closed, "
      "greppable vocabulary")
_make("SEAM010", "no driver module reads the raw Option.Abft knob")
_make("SEAM011", "the raw plan cache (load/save/cache_path/record_plan) is "
      "only touched inside slate_tpu_torch/tune/ — consumers go through "
      "resolve_plan")
_make("SEAM012", "serve/ makes CUDA graphs only through the serve cache "
      "(serve/cache.py) — no CUDAGraph/torch.cuda.graph/Captured/"
      "torch.compile elsewhere in the package, so every capture is "
      "accounted")
_make("SEAM013", "checkpoint serialization (write/read payload+manifest) "
      "only inside robust/checkpoint.py — everyone else goes through "
      "CheckpointManager, so the format and verify ladder have one "
      "blast radius")
_make("SEAM014", "mixed precision is a certified policy: no literal "
      "low-precision cast in drivers//serve/ (the seam is "
      "robust/precision.py), the raw Option.Precision knob is read only "
      "there, and precision boundaries resolve_precision exactly once")
