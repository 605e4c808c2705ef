"""Tile-plan autotuner: measure candidate (kernel, bw, nb) plans per (op,
n, dtype, card), persist the winners to the port's own JSON cache, and
resolve them at every dispatch seam (plans.resolve_plan, the one entry
point the seams use).  The serving layer's bucket ladder rides the same
cache under ``SERVE_BUCKET_OP``, read back through
:func:`plans.serve_buckets`; the out-of-core drivers' streaming panel
width rides it under ``OOC_PANEL_OP`` (:func:`plans.ooc_panel_width`)."""

from .plans import (ALL_OPS, CUDA_PLAN, DIST_LOOKAHEAD_OP, LIBRARY_PLAN,
                    OOC_PANEL_OP, OPS, SCHEMA_VERSION, SERVE_BUCKET_OP,
                    XLA_PLAN, TilePlan, cache_path, chip_kind, load_cache,
                    lookahead_depth, ooc_panel_width, plan_override,
                    record_plan, reload, resolve_plan, save_cache,
                    serve_buckets, validate_cache)

__all__ = ["ALL_OPS", "CUDA_PLAN", "DIST_LOOKAHEAD_OP", "LIBRARY_PLAN",
           "OOC_PANEL_OP", "OPS", "SCHEMA_VERSION", "SERVE_BUCKET_OP",
           "XLA_PLAN", "TilePlan", "cache_path", "chip_kind", "load_cache",
           "lookahead_depth", "ooc_panel_width", "plan_override",
           "record_plan", "reload", "resolve_plan", "save_cache",
           "serve_buckets", "validate_cache"]
