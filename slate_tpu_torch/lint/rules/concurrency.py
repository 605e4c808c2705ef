"""Lock-discipline rules (CON0xx), driven by a declared registry of
guarded state (port of tools/slate_lint/rules/concurrency.py).

The port's cross-thread mutable state — the server's flush/wedge
bookkeeping, the admission queue and its tickets, the device pool, the
SLO latency governor, the executable cache, the obs event sinks, the
tile map, the checkpoint sequence, and the port's own: the plan cache,
the peak-rate cache, the capture sentinel, posv's held graphs and the
kernels' libraries — is each guarded by one lock (a ``threading.Lock``
or, for the admission queue, a ``Condition``, which the rules treat
alike: ``with self._lock:`` acquires either).  The registry below
DECLARES each lock's state: one :class:`LockSpec` names the module, the
owning class (None for a module-level lock), the lock's attribute or
global name, and the names it guards.

Rules:

- **CON001** — guarded state accessed without holding its lock.  The
  walker tracks the held lock through ``with <lock>:`` blocks (resetting
  inside nested ``def``/``lambda``, which run later); ``__init__`` /
  ``__new__`` and module top level are exempt (construction and import
  happen before publication).  A designed lock-free peek is suppressed
  inline with a reason, which keeps every such peek an audited decision.
- **CON002** — lock-order inversion: one path acquires lock B while
  holding A (a nested ``with``, or a call whose transitive callees
  acquire B, over the cross-module call graph with ``self.helper()``
  edges) while another acquires A while holding B; or a path re-acquires
  the non-reentrant lock it holds.
- **CON003** — a known-blocking call under a held lock, made there or by
  a callee (transitively, over the same call graph): a device sync
  (``torch.cuda.synchronize``, ``<stream or event>.synchronize()``),
  ``sleep``, the serving cache's ``get_or_compile`` (a cold call
  captures for seconds), a CUDA-graph capture (internal/graphs.py
  ``Captured(...)``, ``torch.cuda.graph``, ``capture_begin``), or an
  ``nvcc`` build (internal/kernels.py ``start_build`` / ``finish_build``
  / ``build_all``, a ``subprocess`` run or wait).  Holding a lock across
  one serializes every other thread behind it; where the port does so by
  design (``_CAPTURE_LOCK`` around a capture, ``CudaKernel._lock``
  around one build) the site carries a suppression with the reason.
"""

from __future__ import annotations

import ast
from typing import NamedTuple

from .. import callgraph
from ..model import Finding, Rule, register

PKG = "slate_tpu_torch"


class LockSpec(NamedTuple):
    """One declared lock and the state it guards."""
    module: str          # rel path of the declaring module
    cls: str | None      # owning class, None for a module-level lock
    lock: str            # attribute (``self.<lock>``) or global name
    guards: tuple        # state names the lock protects

    @property
    def key(self) -> str:
        scope = f"{self.cls}." if self.cls else ""
        return f"{self.module}::{scope}{self.lock}"


#: the guarded-state registry: one line per lock; CON001-CON003 enforce
#: the discipline.  The first nine are the reference's at the port's
#: paths (the guarded names checked against the port's classes); the rest
#: are the port's own.  A lock with no guards (``()``) serializes work on
#: state the name model cannot see — the device's capture mode, objects
#: reached through other names — and is registered so that CON002 and
#: CON003 hold it all the same.
LOCK_REGISTRY: tuple[LockSpec, ...] = (
    LockSpec(f"{PKG}/serve/server.py", "Server", "_lock",
             ("_inflight", "_flush_deadline", "_wedged", "_flush_error",
              "_quarantined", "_flusher", "_watchdog", "_ladders",
              "_sizes", "_retunes", "_retuning", "_last_retune")),
    LockSpec(f"{PKG}/serve/admission.py", "AdmissionQueue", "_lock",
             ("_items", "_next_id", "_admitted", "_shed", "_closed")),
    LockSpec(f"{PKG}/serve/admission.py", "Ticket", "_lock",
             ("_value", "_error")),
    LockSpec(f"{PKG}/serve/pool.py", "DevicePool", "_lock",
             ("_members", "_rr", "_failovers", "_quarantines",
              "_readmissions")),
    LockSpec(f"{PKG}/obs/slo.py", "LatencyGovernor", "_lock",
             ("_lat", "_dev_lat")),
    LockSpec(f"{PKG}/serve/cache.py", "ExecutableCache", "_lock",
             ("_exes", "_hits", "_misses", "_compile_ms", "_captures")),
    LockSpec(f"{PKG}/obs/events.py", None, "_LOCK",
             ("_CFG", "_RING", "_COLLECTORS")),
    LockSpec(f"{PKG}/core/storage.py", "TileMap", "_lock",
             ("_res", "_device", "_pending")),
    LockSpec(f"{PKG}/robust/checkpoint.py", "CheckpointManager", "_lock",
             ("_seq",)),
    # the plan cache loaded from disk and the memoized resolutions
    # (_OVERRIDES is plan_override's scoped test seam, set and read on the
    # overriding thread, and stays out)
    LockSpec(f"{PKG}/tune/plans.py", None, "_LOCK",
             ("_CACHE", "_CACHE_KEY", "_MEMO")),
    # the card's peak rate per dtype, asked of the device once
    # (_PEAK_OVERRIDE is peak_override's scoped test seam and stays out)
    LockSpec(f"{PKG}/obs/flops.py", None, "_PEAK_LOCK", ("_PEAK",)),
    # the capture counters and the once-per-op warnings
    LockSpec(f"{PKG}/obs/sentinel.py", None, "_LOCK",
             ("_TRACES", "_WARNED")),
    # serializes the replays of one bucket's graphs, which share their
    # static input buffers (inside the Captured objects: no name here)
    LockSpec(f"{PKG}/serve/cache.py", "BucketGraphs", "_lock", ()),
    # Option.HoldLocalWorkspace: the held attempts by key, and each
    # attempt's graph, whose static inputs every replay overwrites
    LockSpec(f"{PKG}/drivers/cholesky.py", None, "_HELD_LOCK", ("_HELD",)),
    LockSpec(f"{PKG}/drivers/cholesky.py", "_HeldAttempt", "lock",
             ("captured",)),
    # the kernels' `replayed` counts, attributes of the CudaKernel
    # objects a graph's tally names (no name of this module)
    LockSpec(f"{PKG}/internal/kernels.py", None, "_REPLAY_LOCK", ()),
    # one kernel's library, built and loaded once
    LockSpec(f"{PKG}/internal/kernels.py", "CudaKernel", "_lock",
             ("_lib",)),
    # one CUDA-graph capture at a time in the process: the device's
    # capture mode, no Python state
    LockSpec(f"{PKG}/internal/graphs.py", None, "_CAPTURE_LOCK", ()),
)

#: constructors run before publication; module top level is import-time
#: single-threaded.  Both are exempt from CON001.
_EXEMPT_METHODS = {"__init__", "__new__"}


def _acquired_spec(expr: ast.AST, rel: str,
                   cls: str | None) -> LockSpec | None:
    """The registry lock a ``with`` context expression acquires, if any."""
    for spec in LOCK_REGISTRY:
        if spec.module != rel:
            continue
        if spec.cls is None:
            if isinstance(expr, ast.Name) and expr.id == spec.lock:
                return spec
        elif cls == spec.cls:
            if isinstance(expr, ast.Attribute) and \
                    isinstance(expr.value, ast.Name) and \
                    expr.value.id == "self" and expr.attr == spec.lock:
                return spec
    return None


def _is_access(node: ast.AST, spec: LockSpec) -> str | None:
    """The guarded name ``node`` reads or writes, if any."""
    if spec.cls is not None:
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self" and node.attr in spec.guards:
            return node.attr
    elif isinstance(node, ast.Name) and node.id in spec.guards:
        return node.id
    return None


def _top_defs(body):
    """Top-level functions and class methods: the roots CON001 checks.
    Nested defs are handled by the walker itself (held-set reset)."""
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield None, node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield node.name, sub


def _unlocked_accesses(node, spec: LockSpec, cls: str | None, held: bool):
    """Yield (access node, guarded name) reached with the lock not held."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.Lambda)):
        body = node.body if isinstance(node.body, list) else [node.body]
        for s in body:  # runs later: the lock is NOT held then
            yield from _unlocked_accesses(s, spec, cls, False)
        return
    if isinstance(node, (ast.With, ast.AsyncWith)):
        inner = held
        for item in node.items:
            yield from _unlocked_accesses(item.context_expr, spec, cls,
                                          held)
            if _acquired_spec(item.context_expr, spec.module, cls) is spec:
                inner = True
        for s in node.body:
            yield from _unlocked_accesses(s, spec, cls, inner)
        return
    name = _is_access(node, spec)
    if name is not None and not held:
        yield node, name
    for child in ast.iter_child_nodes(node):
        yield from _unlocked_accesses(child, spec, cls, held)


def _lock_name(spec: LockSpec) -> str:
    return f"self.{spec.lock}" if spec.cls else spec.lock


@register
class GuardedStateUnlocked(Rule):
    id = "CON001"
    summary = ("registered guarded state accessed without holding its "
               "lock — wrap in `with <lock>:` or suppress a designed "
               "lock-free peek with a reason")

    def run(self, project):
        for spec in LOCK_REGISTRY:
            mod = project.modules.get(spec.module)
            if mod is None or not spec.guards:
                continue
            for cls, fn in _top_defs(mod.tree.body):
                if fn.name in _EXEMPT_METHODS:
                    continue
                if spec.cls is not None and cls != spec.cls:
                    continue
                for stmt in fn.body:
                    for node, name in _unlocked_accesses(
                            stmt, spec, cls, False):
                        lock = _lock_name(spec)
                        yield Finding(
                            self.id, spec.module, node.lineno,
                            f"`{name}` is declared guarded by `{lock}` "
                            f"(lock registry, rules/concurrency.py) but "
                            f"`{fn.name}` touches it without holding the "
                            f"lock — a racing thread tears the state; "
                            f"wrap the access in `with {lock}:`, or "
                            f"suppress stating why lock-free access is "
                            f"safe here")


# --------------------------------------------------------------- CON002/3


def _node_cls(info) -> str | None:
    return getattr(info, "cls", None)


def _direct_locks(info) -> set[str]:
    """Lock keys a function/method body may acquire (over-approximate:
    includes nested defs, which its callers can invoke)."""
    rel, cls = info.module.rel, _node_cls(info)
    out: set[str] = set()
    for n in ast.walk(info.node):
        if isinstance(n, (ast.With, ast.AsyncWith)):
            for item in n.items:
                spec = _acquired_spec(item.context_expr, rel, cls)
                if spec is not None:
                    out.add(spec.key)
    return out


def _call_targets(call: ast.Call, info, cg) -> set[str]:
    """Call-graph keys a call site may reach, incl. self.method edges."""
    rel = info.module.rel
    f = call.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == "self" and \
            isinstance(info, callgraph.MethodInfo):
        mkey = f"{rel}::{info.cls}.{f.attr}"
        if mkey in cg.methods:
            return {mkey}
    scope = info if isinstance(info, callgraph.FuncInfo) else None
    return cg.resolve_call_targets(call, scope, rel)


class _AcquireSummary:
    """Transitive may-acquire lock sets over the call graph."""

    def __init__(self, cg):
        self.cg = cg
        self.memo: dict[str, set[str]] = {}

    def of(self, key: str) -> set[str]:
        if key in self.memo:
            return self.memo[key]
        self.memo[key] = set()          # cycle guard
        info = self.cg.nodes.get(key)
        if info is None:
            return set()
        out = _direct_locks(info)
        for callee in self.cg.callees(key):
            out |= self.of(callee)
        self.memo[key] = out
        return out


def _held_walk(info, on_acquire, on_call):
    """Walk a function body tracking the registry locks held (a tuple of
    LockSpecs, innermost last; reset inside nested defs and lambdas).
    ``on_acquire(held, spec, node)`` runs at each acquisition and
    ``on_call(held, call)`` at each call made with a lock held; both
    yield findings or pairs."""
    rel, cls = info.module.rel, _node_cls(info)

    def walk(node, held):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            body = node.body if isinstance(node.body, list) \
                else [node.body]
            for s in body:
                yield from walk(s, ())
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held
            for item in node.items:
                yield from walk(item.context_expr, held)
                spec = _acquired_spec(item.context_expr, rel, cls)
                if spec is not None:
                    yield from on_acquire(inner, spec, node)
                    inner = (*inner, spec)
            for s in node.body:
                yield from walk(s, inner)
            return
        if isinstance(node, ast.Call) and held:
            yield from on_call(held, node)
        for child in ast.iter_child_nodes(node):
            yield from walk(child, held)

    for stmt in info.node.body:
        yield from walk(stmt, ())


def _held_pairs(info, cg, summary: _AcquireSummary):
    """(held lock key, acquired lock key, lineno) for every acquisition —
    nested ``with`` or transitive through a call — made while a registry
    lock is held."""
    def on_acquire(held, spec, node):
        for h in held:
            yield h.key, spec.key, node.lineno

    def on_call(held, node):
        for t in sorted(_call_targets(node, info, cg)):
            for acquired in sorted(summary.of(t)):
                for h in held:
                    yield h.key, acquired, node.lineno

    yield from _held_walk(info, on_acquire, on_call)


@register
class LockOrderInversion(Rule):
    id = "CON002"
    summary = ("two paths acquire the same two locks in opposite order "
               "(or one path re-acquires a non-reentrant lock) — "
               "deadlock by schedule")

    def run(self, project):
        if not any(s.module in project.modules for s in LOCK_REGISTRY):
            return
        cg = callgraph.compute(project)
        summary = _AcquireSummary(cg)
        pairs: dict = {}                # (held, acquired) -> (rel, line)
        for key in sorted(cg.nodes):
            info = cg.nodes[key]
            for held, acquired, line in _held_pairs(info, cg, summary):
                pairs.setdefault((held, acquired),
                                 (info.module.rel, line))
        for (a, b) in sorted(pairs):
            rel, line = pairs[(a, b)]
            if a == b:
                yield Finding(
                    self.id, rel, line,
                    f"path re-acquires `{a}` while already holding it — "
                    f"threading.Lock is non-reentrant, so this "
                    f"self-deadlocks; release first or restructure the "
                    f"callee to expect the lock held")
            elif a < b and (b, a) in pairs:
                orel, oline = pairs[(b, a)]
                yield Finding(
                    self.id, rel, line,
                    f"lock-order inversion: this path acquires `{b}` "
                    f"while holding `{a}`, but {orel}:{oline} acquires "
                    f"`{a}` while holding `{b}` — two threads "
                    f"interleaving these paths deadlock; pick one global "
                    f"order and restructure the loser")


#: calls that block for milliseconds to seconds, by their last name
BLOCKING_NAMES = {
    "synchronize",        # torch.cuda.synchronize(), stream/event sync
    "sleep",
    "get_or_compile",     # the serving cache: a cold call captures
    "Captured",           # internal/graphs.py: warm-up + graph capture
    "capture_begin",      # a raw CUDA-graph capture
    "start_build",        # internal/kernels.py: nvcc for one source
    "finish_build",       # ... and the wait for it
    "build_all",          # every kernel's nvcc at once
}
#: subprocess calls that run a child to its end
SUBPROCESS_WAITS = {"run", "call", "check_call", "check_output"}


def _blocking_call(node: ast.Call) -> str | None:
    f = node.func
    name = (f.id if isinstance(f, ast.Name)
            else f.attr if isinstance(f, ast.Attribute) else None)
    if name in BLOCKING_NAMES:
        return name
    if isinstance(f, ast.Attribute):
        base = f.value
        if name == "graph" and ((isinstance(base, ast.Attribute)
                                 and base.attr == "cuda")
                                or (isinstance(base, ast.Name)
                                    and base.id == "cuda")):
            return "torch.cuda.graph"
        if name in SUBPROCESS_WAITS and isinstance(base, ast.Name) and \
                base.id == "subprocess":
            return f"subprocess.{name}"
    return None


class _BlockSummary:
    """Per function: the chain of calls by which it may block (its own
    blocking call, or a callee's chain behind the callee's name), or
    None."""

    def __init__(self, cg):
        self.cg = cg
        self.memo: dict[str, tuple | None] = {}

    def of(self, key: str) -> tuple | None:
        if key in self.memo:
            return self.memo[key]
        self.memo[key] = None           # cycle guard
        info = self.cg.nodes.get(key)
        if info is None:
            return None
        chain = None
        for node in callgraph.own_nodes(info.node):
            if isinstance(node, ast.Call):
                what = _blocking_call(node)
                if what is not None:
                    chain = (what,)
                    break
        if chain is None:
            for callee in sorted(self.cg.callees(key)):
                sub = self.of(callee)
                if sub is not None:
                    chain = (callee.split("::", 1)[1], *sub)
                    break
        self.memo[key] = chain
        return chain


@register
class BlockingCallUnderLock(Rule):
    id = "CON003"
    summary = ("known-blocking call (device sync, sleep, graph capture, "
               "get_or_compile, nvcc build), made directly or by a callee, "
               "under a held registry lock — serializes every other "
               "thread behind it")

    def run(self, project):
        if not any(s.module in project.modules for s in LOCK_REGISTRY):
            return
        cg = callgraph.compute(project)
        summary = _BlockSummary(cg)
        for key in sorted(cg.nodes):
            yield from self._check(cg.nodes[key], cg, summary)

    def _check(self, info, cg, summary):
        def on_acquire(held, spec, node):
            return ()

        def on_call(held, node):
            what = _blocking_call(node)
            if what is None:
                for t in sorted(_call_targets(node, info, cg)):
                    chain = summary.of(t)
                    if chain is not None:
                        what = " -> ".join((t.split("::", 1)[1], *chain))
                        break
            if what is not None:
                yield Finding(
                    self.id, info.module.rel, node.lineno,
                    f"`{what}` under held `{_lock_name(held[-1])}` — a "
                    f"capture, build or device sync takes milliseconds to "
                    f"seconds and every thread contending for the lock "
                    f"stalls behind it; move the blocking work outside "
                    f"the critical section and re-check state after "
                    f"re-acquiring (serve/cache.py's capture-outside-the-"
                    f"lock pattern)")

        yield from _held_walk(info, on_acquire, on_call)
