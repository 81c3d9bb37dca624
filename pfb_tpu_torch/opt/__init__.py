"""Solvers of the port: power method, primal-dual, conjugate
gradients."""
