"""Solvers of the port: power method, primal-dual (with its host loop),
conjugate gradients (per band, host-loop and fused forms), FISTA."""
