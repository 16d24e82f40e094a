"""Faults planted under the timed path, for the test that sees ``correct``
come out false and for the readings that set the limits' upper ends.

Each driver names the faults its path can have and plants them: its
``faults(bench)`` lists them and its ``plant(name)`` is a context manager
that patches the port for its ``with`` block. The names in use:

- ``unchanged``: a step returns its state unchanged (the loss is still
  computed and reported);
- ``half_batch``: each worker's step leaves out the second half of its
  rows and takes the mean over the rest;
- ``merge_skipped``: the merge rule leaves the center and the workers as
  they are (the exchange between the workers left out).
"""

from __future__ import annotations

import contextlib

from portbench import core


def for_cell(bench) -> tuple:
    """The faults the cell's path can have."""
    return tuple(core.load_driver(bench.cell["driver"]).faults(bench))


@contextlib.contextmanager
def planted(bench, name: str | None):
    """The fault ``name`` of the cell's driver planted in the port for the
    ``with`` block (none for None)."""
    if name is None:
        yield
        return
    if name not in for_cell(bench):
        raise ValueError(f"{bench.name} has no fault {name!r}")
    with core.load_driver(bench.cell["driver"]).plant(name):
        yield
