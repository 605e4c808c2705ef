"""Fault injection (slate_tpu/robust/faults.py) is not ported yet.

The reference's drivers carry fault sites (``input``, ``post_panel``,
``solve``, ...) that a test arms with ``faults.inject``.  The port's
drivers have no sites until the robustness slice; arming one raises
rather than running a fault-free solve that looks as if it was tested.
"""

from __future__ import annotations

from ..exceptions import not_ported


def inject(*plans):
    """Arm fault plans: not ported, always raises NotImplementedError."""
    raise not_ported("fault injection sites", "queue 1, item 6 (robustness)")
