"""The rule packs; importing this package registers every rule."""

from . import concurrency, obs, seams  # noqa: F401
