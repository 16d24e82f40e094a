"""The merge rules from their equations, one file a rule:
``fold(delta)`` takes the workers' ``worker_i − center``, stacked
``[W, …]``, and returns the center's increment."""
