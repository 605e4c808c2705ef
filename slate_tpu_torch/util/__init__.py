"""util layer of slate_tpu_torch (see the package docstring)."""
