"""Project loading: find the source files, parse them, collect their
suppressions (port of tools/slate_lint/loader.py).

The default scan is the port's package, ``slate_tpu_torch/``, under the
project root, without its ``examples/``: as in the reference, whose scan
leaves the repo's ``tests/`` and ``examples/`` out, examples and rule
fixtures may break the rules on purpose.

Pure stdlib (``ast`` + ``tokenize``): the analyzer never imports the code
it checks, so it needs neither torch nor a GPU.
"""

from __future__ import annotations

import ast
import io
import tokenize
from pathlib import Path

from .model import parse_suppressions

PACKAGE = "slate_tpu_torch"
DEFAULT_TARGETS = (PACKAGE,)
#: directories under a target that the scan leaves out
EXCLUDED = (f"{PACKAGE}/examples/",)


class SourceModule:
    """One parsed file: AST, dotted module name, per-line suppressions."""

    def __init__(self, root: Path, path: Path, text: str):
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.text = text
        self.tree = ast.parse(text, filename=str(path))
        self.dotted = self.rel[:-3].replace("/", ".")  # a/b/c.py -> a.b.c
        if self.dotted.endswith(".__init__"):
            self.dotted = self.dotted[: -len(".__init__")]
        self.suppressions = parse_suppressions(_comments(text))
        self._nodes: list | None = None

    @property
    def nodes(self) -> list:
        """Every node of the tree (``ast.walk`` order), listed once: the
        rules scan it many times."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    def suppressed(self, line: int, rule: str) -> bool:
        rules = self.suppressions.get(line, ())
        return rule in rules or "all" in rules


def _comments(text: str) -> list[tuple[int, str, bool]]:
    """(lineno, comment, standalone?) for every comment token.  tokenize
    (not a regex) so a ``#`` inside a string literal is never misread."""
    out = []
    lines = text.splitlines()
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                lineno, col = tok.start
                src_line = lines[lineno - 1] if lineno <= len(lines) else ""
                standalone = not src_line[:col].strip()
                out.append((lineno, tok.string, standalone))
    except tokenize.TokenError:  # unterminated strings etc: best effort
        pass
    return out


class Project:
    """The loaded tree: modules by root-relative path, plus a scratch
    cache the rules share (the call graph, the seam scan)."""

    def __init__(self, root: Path, modules: dict[str, SourceModule]):
        self.root = root
        self.modules = modules
        self.by_dotted = {m.dotted: m for m in modules.values()}
        self.cache: dict[str, object] = {}

    def module(self, rel: str) -> SourceModule | None:
        return self.modules.get(rel)


def iter_source_files(root: Path, targets=DEFAULT_TARGETS):
    for target in targets:
        p = root / target
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not f.relative_to(root).as_posix().startswith(EXCLUDED):
                    yield f


def load_project(root: Path | str, targets=DEFAULT_TARGETS) -> Project:
    root = Path(root).resolve()
    modules: dict[str, SourceModule] = {}
    for path in iter_source_files(root, targets):
        try:
            mod = SourceModule(root, path, path.read_text())
        except (SyntaxError, UnicodeDecodeError):
            # unparseable files are invisible to the analyzer; the test
            # suite catches them long before lint does
            continue
        modules[mod.rel] = mod
    return Project(root, modules)
