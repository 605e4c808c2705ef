"""Core data model: findings, the rule registry, suppressions (port of
tools/slate_lint/model.py).

A *rule* is a plugin: a class with an ``id``, a one-line ``summary`` and
a ``run(project)`` generator of :class:`Finding`.  Rules register
themselves with :func:`register`; the engine finds them through
:data:`REGISTRY`, which importing ``slate_tpu_torch.lint.rules`` fills.

Suppressions are per-line comments::

    return _CFG["timing"]  # slate-lint: disable=CON001 -- lock-free peek

A standalone suppression comment (a line that is only the comment)
applies to the next line as well, so a long statement can be annotated
without breaking it.  The ``-- reason`` tail is the policy for every
suppression (the port keeps no baseline file: each tolerated site says
why at the site), though the parser does not enforce it.
"""

from __future__ import annotations

import dataclasses
import re

SUPPRESS_RE = re.compile(
    r"#\s*slate-lint:\s*disable=([A-Za-z0-9_,\s]+?)\s*(?:--\s*(?P<reason>.*))?$"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: rule id, root-relative posix path, 1-based line."""

    rule: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}


class Rule:
    """Base class for rule plugins.  Subclasses set ``id`` and ``summary``
    and implement ``run``."""

    id: str = ""
    summary: str = ""

    def run(self, project):  # pragma: no cover - interface
        raise NotImplementedError
        yield


#: rule id -> Rule instance, in registration order
REGISTRY: dict[str, Rule] = {}


def register(cls: type[Rule]) -> type[Rule]:
    """Class decorator adding a rule to :data:`REGISTRY`."""
    inst = cls()
    if not inst.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if inst.id in REGISTRY:
        raise ValueError(f"duplicate rule id {inst.id}")
    REGISTRY[inst.id] = inst
    return cls


def parse_suppressions(comment_lines: list[tuple[int, str, bool]]
                       ) -> dict[int, set[str]]:
    """Map line numbers to the rule ids suppressed there.

    ``comment_lines`` is ``(lineno, comment_text, standalone)`` per comment
    token; a standalone comment suppresses the following line as well."""
    out: dict[int, set[str]] = {}
    for lineno, text, standalone in comment_lines:
        m = SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        out.setdefault(lineno, set()).update(rules)
        if standalone:
            out.setdefault(lineno + 1, set()).update(rules)
    return out
