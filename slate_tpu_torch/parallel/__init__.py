"""parallel layer of slate_tpu_torch: the distributed BLAS-3 and Cholesky
kernels over a p x q grid (see the package docstring)."""
