"""One reader per metric, ``<metric>.py`` with ``read(ctx)`` returning the
number in the metric's unit, or None where it finds nothing to read (the
harness then leaves the metric out). ``ctx`` is ``run.Context``: the
cell's files, the set-up's and the window's times, what the window
trained, the window's peak memory and, in a traced run, its trace."""
