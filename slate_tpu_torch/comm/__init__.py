"""comm layer of slate_tpu_torch: collectives over the grid's process
groups (see the package docstring)."""
