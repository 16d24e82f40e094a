"""Device time a window of the operations launched inside
``engine.update`` (the optimizer and the workers' parameter add), in ms,
from the traced run's pass with the port's spans on
(``portbench.spanpass``). One file for every suffix."""

from portbench import spanpass


def read(ctx):
    s = spanpass.split(ctx)
    return None if s is None else s.phase_ms("engine.update")
