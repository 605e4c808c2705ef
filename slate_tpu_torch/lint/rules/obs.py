"""Observability rules (OBS0xx), port of tools/slate_lint/rules/obs.py.

OBS001 — drivers, internal kernels and parallel kernels do NOT emit
ad-hoc telemetry: no ``print``, no ``logging`` module, no callbacks.  The
port's telemetry has one spine (``slate_tpu_torch/obs``): driver
boundaries emit structured events through ``util.trace.annotate`` and
phases are marked with ``util.trace.span``.  A stray ``print`` is
invisible to the metrics CLI.  ``drivers/printing.py`` is exempt:
pretty-printing matrices to stdout is its contract.

OBS002 — every ``@annotate("slate.<op>")``-decorated driver has a flop
model registered in ``slate_tpu_torch/obs/flops.py`` (its
``@register("<op>", ...)`` string literals are the source of truth, read
by AST).  Without a model the op's events read ``mfu: n/a`` forever;
skipping the model is an EXPLICIT ``# slate-lint: disable=OBS002 --
reason`` on the decorator line (the band drivers: bandwidth is not
recoverable from event shapes).
"""

from __future__ import annotations

import ast

from ..model import Finding, Rule, register

PKG = "slate_tpu_torch"
#: directories whose modules must stay telemetry-clean
CHECKED_PREFIXES = (f"{PKG}/drivers/", f"{PKG}/internal/",
                    f"{PKG}/parallel/")
#: stdout IS the contract here
EXEMPT_FILES = {f"{PKG}/drivers/printing.py"}

#: call / import names that bypass the obs spine
BANNED_CALLS = {"print", "io_callback", "pure_callback", "debug_print"}
BANNED_MODULES = {"logging"}

#: the one module whose @register("<op>") literals define the model set
FLOPS_MODULE = f"{PKG}/obs/flops.py"


def _name(f) -> str | None:
    return f.id if isinstance(f, ast.Name) else (
        f.attr if isinstance(f, ast.Attribute) else None)


def _call_name(node: ast.Call):
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in ("print", "callback"):
        base = f.value          # debug.print / jax.debug.callback spellings
        if _name(base) == "debug":
            return f"debug.{f.attr}"
        return None
    name = _name(f)
    return name if name in BANNED_CALLS else None


@register
class Obs001(Rule):
    id = "OBS001"
    summary = ("drivers/internal/parallel emit no ad-hoc telemetry "
               "(print/logging/callbacks) — observability goes through "
               "the slate_tpu_torch.obs spine (annotate/span/events)")

    def run(self, project):
        for rel in sorted(project.modules):
            if not rel.startswith(CHECKED_PREFIXES) or rel in EXEMPT_FILES:
                continue
            for node in project.modules[rel].nodes:
                if isinstance(node, (ast.Import, ast.ImportFrom)):
                    mods = ([a.name.split(".")[0] for a in node.names]
                            if isinstance(node, ast.Import)
                            else [(node.module or "").split(".")[0]])
                    hit = BANNED_MODULES.intersection(mods)
                    if hit:
                        yield Finding(
                            self.id, rel, node.lineno,
                            f"imports `{sorted(hit)[0]}` — route telemetry "
                            f"through slate_tpu_torch.obs (annotate/span), "
                            f"not ad-hoc logging")
                elif isinstance(node, ast.Call):
                    name = _call_name(node)
                    if name is not None:
                        yield Finding(
                            self.id, rel, node.lineno,
                            f"calls `{name}` — drivers/internal/parallel "
                            f"emit telemetry only through the obs spine "
                            f"(util.trace.annotate / span / obs.events)")


def _registered_flops_ops(project) -> set | None:
    """Op names registered in FLOPS_MODULE, by AST literal scan; None when
    the module is absent (a mini tree without a registry is not checked)."""
    if "obs002:registered" not in project.cache:
        mod = project.modules.get(FLOPS_MODULE)
        ops = None
        if mod is not None:
            ops = {arg.value for node in mod.nodes
                   if isinstance(node, ast.Call)
                   and _name(node.func) == "register"
                   for arg in node.args
                   if isinstance(arg, ast.Constant)
                   and isinstance(arg.value, str)}
        project.cache["obs002:registered"] = ops
    return project.cache["obs002:registered"]


def _annotate_op(dec) -> str | None:
    """The 'slate.<op>' literal of an @annotate decorator call, if any."""
    if not isinstance(dec, ast.Call) or not dec.args or \
            _name(dec.func) != "annotate":
        return None
    arg = dec.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
            and arg.value.startswith("slate."):
        return arg.value[len("slate."):]
    return None


@register
class Obs002(Rule):
    id = "OBS002"
    summary = ("every @annotate-decorated public driver has a flops model "
               "registered in obs/flops.py (or an explicit disable) — the "
               "MFU column never silently reads n/a for a new op")

    def run(self, project):
        registered = _registered_flops_ops(project)
        if registered is None:
            return
        for rel in sorted(project.modules):
            if not rel.startswith(PKG + "/"):
                continue
            for node in project.modules[rel].nodes:
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                for dec in node.decorator_list:
                    op = _annotate_op(dec)
                    if op is not None and op not in registered:
                        yield Finding(
                            self.id, rel, dec.lineno,
                            f"driver `{node.name}` (slate.{op}) has no "
                            f"flops model in obs/flops.py — register one "
                            f"(@register(\"{op}\")) or disable with a "
                            f"reason")
