"""slate-lint for the port: the drivers' robustness contract as static
checks over ``slate_tpu_torch/`` (port of tools/slate_lint's SEAM, CON
and OBS packs; the reference's TRC and COL packs check JAX tracing and
mesh axis names, which have no eager counterpart).

- **SEAM001–014** (rules/seams.py): the policy seams of
  docs/ROBUSTNESS.md — drivers take ``opts`` and route failures through
  the health machinery, each knob (Speculate, Abft, Precision) is
  resolved exactly once at its boundary, fault sites are a closed
  vocabulary, and the plan cache, the serving graph cache and checkpoint
  serialization each have one owner;
- **CON001–003** (rules/concurrency.py): lock discipline over a declared
  registry of guarded state, lock order over the cross-module call graph
  (callgraph.py), and no capture, build or device sync under a lock;
- **OBS001–002** (rules/obs.py): no ad-hoc telemetry in drivers,
  internal and parallel modules, and a flop model for every annotated
  driver.

Pure stdlib: the analyzer parses the tree and never imports it.  Run
``python -m slate_tpu_torch.lint`` from the repo root.
"""

from .cli import main, run_rules  # noqa: F401
from .loader import load_project  # noqa: F401
from .model import REGISTRY, Finding, Rule, register  # noqa: F401

__all__ = ["main", "run_rules", "load_project", "REGISTRY", "Finding",
           "Rule", "register"]
