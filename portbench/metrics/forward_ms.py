"""Device time a window of the operations launched inside
``engine.forward`` (the workers' vmapped forward, loss included), in ms,
from the traced run's pass with the port's spans on
(``portbench.spanpass``). One file for every suffix (``.tokens``,
``.samples``)."""

from portbench import spanpass


def read(ctx):
    s = spanpass.split(ctx)
    return None if s is None else s.phase_ms("engine.forward")
