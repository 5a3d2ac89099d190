"""Scripts of the port: the convergence gate (acceptance_run)."""
