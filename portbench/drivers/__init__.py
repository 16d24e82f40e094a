"""How a window drives one path of the port: ``drivers/<driver>.py``
holds a class ``Driver(bench, seed, device)`` with

- ``lead, window, batch``: the layout of a checked window's columns
  ``[lead, window, batch, …]`` (workers, local steps, rows);
- ``shapes``: ``{parameter: shape}`` of the model;
- ``first_steps()``: the set-up's first windows of the timed path, on the
  state the window then continues, and their readings for the
  comparison;
- ``epoch()``: one epoch of the timed path, launched and not waited for;
- ``counts``: what one epoch trains (``tokens``, ``samples``,
  ``windows``: engine windows, or steps);
- ``release()``: the program's state freed;

and functions ``faults(bench)``, the faults the path can have,
``plant(name)``, a context manager that plants one (``portbench.faults``),
and ``tiny(bench)``, which cuts a cell's trainer in place to the size of
the CPU's tests.

``common`` holds what the drivers share.
"""
