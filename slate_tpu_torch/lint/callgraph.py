"""Cross-module call graph, the spine of the lock-order and blocking-call
rules (port of tools/slate_lint/callgraph.py with the part of
reachability.py it needs: the function index, the import maps and call
resolution).

The reference's reachability pass also finds the functions JAX traces
(jit / shard_map / pallas_call entries and their closure) for its
trace-safety and collective rules; the port runs eagerly and has neither
rule, so only the resolution is kept.

Edges are lexical and best-effort:

- a ``Name`` resolves through the enclosing-function chain, then the
  module's ``def``\\ s, then its import map (``from ..internal import
  gemm`` makes ``gemm.fn`` resolvable);
- **re-exports** — ``pkg.fn`` where ``pkg/__init__.py`` only imports
  ``fn`` from a submodule — follow import maps recursively (cycle-guarded)
  until they land on a real ``def``;
- **dict-dispatch tables** — module-level ``NAME = {"k": fn, ...}`` maps of
  resolvable functions (the ``serve.batched.CORES`` idiom): a call through
  a table (``CORES[op](...)``, or ``core = CORES[op]; core(...)``) may
  reach ANY value of the table, so every value becomes an edge;
- **methods** — ``self.other()`` within a class (``<rel>::<Class>.<m>``),
  so lock analysis sees ``Server``'s and ``ExecutableCache``'s helper
  chains.

``getattr`` and tables built at run time stay unresolved.
"""

from __future__ import annotations

import ast

from .loader import Project, SourceModule


class FuncInfo:
    """One ``def`` in the project (module level or nested), with its
    resolved callees."""

    def __init__(self, key: str, node: ast.FunctionDef,
                 module: SourceModule, parent: "FuncInfo | None"):
        self.key = key              # "<rel>::<dotted nesting path>"
        self.node = node
        self.module = module
        self.parent = parent
        self.children: dict[str, "FuncInfo"] = {}
        self.resolved_calls: set[str] = set()   # keys of called functions
        self.resolved_refs: set[str] = set()    # keys of referenced functions


class MethodInfo:
    """One class method: enough context for lock-discipline analysis."""

    def __init__(self, key: str, node: ast.FunctionDef,
                 module: SourceModule, cls: str):
        self.key = key              # "<rel>::<Class>.<method>"
        self.node = node
        self.module = module
        self.cls = cls


def _nested_defs(fn_node: ast.AST):
    """The defs whose NEAREST enclosing def is ``fn_node`` (deeper nesting
    is indexed recursively under its own parent)."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node
            continue
        stack.extend(ast.iter_child_nodes(node))


def own_nodes(fn_node: ast.AST):
    """Walk a function body without descending into nested ``def``\\ s
    (those are FuncInfos of their own); lambda bodies ARE included."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _import_map(mod: SourceModule) -> dict[str, str]:
    """Local name -> dotted target for the module's imports."""
    parts = mod.dotted.split(".")
    is_pkg = mod.rel.endswith("__init__.py")
    pkg = parts if is_pkg else parts[:-1]
    out: dict[str, str] = {}
    for node in mod.nodes:
        if isinstance(node, ast.Import):
            for alias in node.names:
                out[alias.asname or alias.name.split(".")[0]] = (
                    alias.name if alias.asname else alias.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[: len(pkg) - (node.level - 1)]
                prefix = ".".join(base + (node.module.split(".")
                                          if node.module else []))
            else:
                prefix = node.module or ""
            for alias in node.names:
                if alias.name == "*":
                    continue
                out[alias.asname or alias.name] = (
                    f"{prefix}.{alias.name}" if prefix else alias.name)
    return out


def _iter_class_methods(module: SourceModule):
    for node in module.tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        for sub in node.body:
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node.name, sub


class CallGraph:
    """Edges over module functions and class methods.

    Keys are function keys (``<rel>::<qual>``) and method keys
    (``<rel>::<Class>.<method>``); ``nodes`` maps each to its
    :class:`FuncInfo` / :class:`MethodInfo`."""

    def __init__(self, project: Project):
        self.project = project
        self.functions: dict[str, FuncInfo] = {}
        self.module_funcs: dict[str, dict[str, str]] = {}  # rel -> name->key
        self.imports: dict[str, dict[str, str]] = {}       # rel -> name->dotted
        self._alias_memo: dict[str, dict[str, tuple[str, ...]]] = {}
        self._index()
        self.dispatch_tables = self._collect_dispatch_tables()
        for key, info in self.functions.items():
            rel = info.module.rel
            for node in own_nodes(info.node):
                if isinstance(node, ast.Call):
                    info.resolved_calls.update(
                        self.resolve_call_targets(node, info, rel))
                elif isinstance(node, ast.Name) and isinstance(
                        node.ctx, ast.Load):
                    target = self.resolve_name(node.id, info, rel)
                    if target:
                        info.resolved_refs.add(target)
                elif (isinstance(node, ast.Attribute)
                      and isinstance(node.ctx, ast.Load)
                      and isinstance(node.value, ast.Name)):
                    target = self.resolve_attr(node.value.id, node.attr, rel)
                    if target:
                        info.resolved_refs.add(target)
        self.methods: dict[str, MethodInfo] = {}
        for rel, mod in project.modules.items():
            for cls, node in _iter_class_methods(mod):
                mi = MethodInfo(f"{rel}::{cls}.{node.name}", node, mod, cls)
                self.methods[mi.key] = mi
        self.nodes: dict[str, object] = {**self.functions, **self.methods}
        self.edges: dict[str, set[str]] = {}
        for key, info in self.functions.items():
            self.edges[key] = (set(info.resolved_calls)
                               | set(info.resolved_refs)
                               | {c.key for c in info.children.values()})
        for key, mi in self.methods.items():
            self.edges[key] = self._method_edges(mi)

    # ---- indexing -----------------------------------------------------

    def _index(self):
        for rel, mod in self.project.modules.items():
            self.imports[rel] = _import_map(mod)
            table: dict[str, str] = {}

            def add(node, parent: FuncInfo | None, prefix: str):
                qual = f"{prefix}{node.name}" if prefix else node.name
                info = FuncInfo(f"{rel}::{qual}", node, mod, parent)
                self.functions[info.key] = info
                if parent is None:
                    table[node.name] = info.key
                else:
                    parent.children[node.name] = info
                for child in _nested_defs(node):
                    add(child, info, f"{qual}.")

            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    add(node, None, "")
            self.module_funcs[rel] = table

    def _collect_dispatch_tables(self) -> dict[str, dict[str, tuple]]:
        """``rel -> {table_name: (function keys...)}`` for module-level
        dict-dispatch tables.  A table is recorded when at least one value
        resolves to a project function; unresolvable values are skipped,
        keeping the edge set an under-approximation rather than a guess."""
        tables: dict[str, dict[str, tuple[str, ...]]] = {}
        for rel, mod in self.project.modules.items():
            per: dict[str, tuple[str, ...]] = {}
            for node in mod.tree.body:
                if isinstance(node, ast.Assign):
                    targets = [t for t in node.targets
                               if isinstance(t, ast.Name)]
                    value = node.value
                elif isinstance(node, ast.AnnAssign) and \
                        isinstance(node.target, ast.Name):
                    targets = [node.target]
                    value = node.value
                else:
                    continue
                if not targets or not isinstance(value, ast.Dict):
                    continue
                keys: list[str] = []
                for v in value.values:
                    k = None
                    if isinstance(v, ast.Name):
                        k = self.resolve_name(v.id, None, rel)
                    elif isinstance(v, ast.Attribute) and \
                            isinstance(v.value, ast.Name):
                        k = self.resolve_attr(v.value.id, v.attr, rel)
                    if k:
                        keys.append(k)
                if keys:
                    for t in targets:
                        per[t.id] = tuple(dict.fromkeys(keys))
            if per:
                tables[rel] = per
        return tables

    # ---- name resolution ---------------------------------------------

    def resolve_name(self, name: str, scope: FuncInfo | None,
                     rel: str) -> str | None:
        """Resolve a bare name at a scope to a function key."""
        fn = scope
        while fn is not None:
            if name in fn.children:
                return fn.children[name].key
            fn = fn.parent
        if name in self.module_funcs.get(rel, ()):
            return self.module_funcs[rel][name]
        dotted = self.imports.get(rel, {}).get(name)
        if dotted:
            return self._resolve_dotted(dotted)
        return None

    def resolve_attr(self, base: str, attr: str, rel: str) -> str | None:
        """Resolve ``base.attr`` where base is an imported module alias."""
        dotted = self.imports.get(rel, {}).get(base)
        if dotted:
            return self._resolve_dotted(f"{dotted}.{attr}")
        return None

    def _resolve_dotted(self, dotted: str,
                        _seen: set[str] | None = None) -> str | None:
        """``pkg.mod.fn`` -> key when pkg.mod is a project module, following
        re-exports through import maps."""
        if dotted in self.project.by_dotted:  # a module, not a function
            return None
        mod_name, _, fn_name = dotted.rpartition(".")
        mod = self.project.by_dotted.get(mod_name)
        if mod is None:
            return None
        key = self.module_funcs.get(mod.rel, {}).get(fn_name)
        if key is not None:
            return key
        fwd = self.imports.get(mod.rel, {}).get(fn_name)
        if fwd and fwd != dotted:
            seen = _seen if _seen is not None else set()
            if dotted not in seen:
                seen.add(dotted)
                return self._resolve_dotted(fwd, seen)
        return None

    def _dispatch_table(self, expr: ast.AST, rel: str
                        ) -> tuple[str, ...] | None:
        """Function keys of the dispatch table ``expr`` names, if any: a
        table of this module, ``mod.TABLE`` through the import map, or a
        re-exported table."""
        if isinstance(expr, ast.Name):
            tab = self.dispatch_tables.get(rel, {}).get(expr.id)
            if tab:
                return tab
            dotted = self.imports.get(rel, {}).get(expr.id)
            if dotted:
                return self._dotted_table(dotted)
        if isinstance(expr, ast.Attribute) and isinstance(expr.value,
                                                          ast.Name):
            dotted = self.imports.get(rel, {}).get(expr.value.id)
            if dotted:
                return self._dotted_table(f"{dotted}.{expr.attr}")
        return None

    def _dotted_table(self, dotted: str,
                      _seen: set[str] | None = None
                      ) -> tuple[str, ...] | None:
        mod_name, _, name = dotted.rpartition(".")
        mod = self.project.by_dotted.get(mod_name)
        if mod is None:
            return None
        tab = self.dispatch_tables.get(mod.rel, {}).get(name)
        if tab:
            return tab
        fwd = self.imports.get(mod.rel, {}).get(name)
        if fwd and fwd != dotted:
            seen = _seen if _seen is not None else set()
            if dotted not in seen:
                seen.add(dotted)
                return self._dotted_table(fwd, seen)
        return None

    def _dispatch_aliases(self, scope: FuncInfo | None
                          ) -> dict[str, tuple[str, ...]]:
        """Local name -> table keys for ``core = CORES[op]`` assignments
        in the enclosing-function chain (memoized)."""
        if scope is None:
            return {}
        cached = self._alias_memo.get(scope.key)
        if cached is None:
            cached = dict(self._dispatch_aliases(scope.parent))
            rel = scope.module.rel
            for node in own_nodes(scope.node):
                if isinstance(node, ast.Assign) and \
                        isinstance(node.value, ast.Subscript):
                    tab = self._dispatch_table(node.value.value, rel)
                    if tab:
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                cached[t.id] = tab
            self._alias_memo[scope.key] = cached
        return cached

    def resolve_call_targets(self, call: ast.Call, scope: FuncInfo | None,
                             rel: str) -> set[str]:
        """Every function key a call may reach: the one lexical target
        plus dict-dispatch edges."""
        out: set[str] = set()
        f = call.func
        single = None
        if isinstance(f, ast.Name):
            single = self.resolve_name(f.id, scope, rel)
        elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            single = self.resolve_attr(f.value.id, f.attr, rel)
        if single:
            out.add(single)
        if isinstance(f, ast.Subscript):
            tab = self._dispatch_table(f.value, rel)
            if tab:
                out.update(tab)
        elif isinstance(f, ast.Name) and single is None:
            tab = self._dispatch_aliases(scope).get(f.id)
            if tab:
                out.update(tab)
        return out

    # ---- methods -----------------------------------------------------

    def _method_edges(self, mi: MethodInfo) -> set[str]:
        rel = mi.module.rel
        out: set[str] = set()
        for node in own_nodes(mi.node):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Name) and f.value.id == "self":
                mkey = f"{rel}::{mi.cls}.{f.attr}"
                if mkey in self.methods:
                    out.add(mkey)
                    continue
            out.update(self.resolve_call_targets(node, None, rel))
        return out

    def callees(self, key: str) -> set[str]:
        return self.edges.get(key, set())


def compute(project: Project) -> CallGraph:
    if "callgraph" not in project.cache:
        project.cache["callgraph"] = CallGraph(project)
    return project.cache["callgraph"]
