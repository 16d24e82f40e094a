"""Observability of the port: the flight-recorder span tracer
(:mod:`~distkeras_tpu_torch.observability.trace`)."""
