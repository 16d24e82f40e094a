"""Device time a window of the operations launched inside the expert
layer's ``moe.*`` spans (``moe.route``, ``moe.experts``, ``moe.combine``
on the engine's thread, ``moe.backward`` on autograd's), in any phase,
in ms, from the traced run's pass with the port's spans on
(``portbench.spanpass``). One file for every suffix."""

from portbench import spanpass


def read(ctx):
    s = spanpass.split(ctx)
    return None if s is None else s.part_ms("moe.")
