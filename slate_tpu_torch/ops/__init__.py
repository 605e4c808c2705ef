"""ops layer of slate_tpu_torch: tile-array kernels in plain torch."""
