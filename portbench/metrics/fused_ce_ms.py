"""Device time a window of the operations launched inside
``fused_ce.forward`` or ``fused_ce.backward`` (``ops/fused_ce.py``: the
chunked CE's products and f32 chunk work), in any phase, in ms, from the
traced run's pass with the port's spans on (``portbench.spanpass``). One
file for every suffix."""

from portbench import spanpass, spans


def read(ctx):
    s = spanpass.split(ctx)
    return None if s is None else s.part_ms(spans.FUSED_CE)
