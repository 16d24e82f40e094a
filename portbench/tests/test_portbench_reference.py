"""The plain reference against the port's CPU path at tiny shapes: in f32
the two agree to rounding on every cell's path (the port's trainer, engine,
model, fused Adam and merge rule against the reference's equations)."""

from __future__ import annotations

from portbench import core, run
from portbench.tests.conftest import tiny


def _readings(b, seed):
    drv = core.load_driver(b.cell["driver"]).Driver(b, seed, "cpu")
    prog = drv.first_steps()
    layout = dict(lead=drv.lead, window=drv.window, batch=drv.batch,
                  shapes=drv.shapes)
    drv.release()
    return prog, run.reference_readings(b, layout, seed, "cpu")


def test_reference_matches_the_port_in_f32(cell):
    prog, ref = _readings(tiny(cell, "float32"), 2 ** 31 + 17)
    numbers = core.compare(prog, ref)
    assert numbers["loss"][0] < 1e-5
    assert numbers["grad"][0] < 1e-5
    assert numbers["change"][0] < 1e-3
    assert len(prog["loss"]) == core.CHECKED_WINDOWS


def test_bf16_port_stays_near_the_reference(cell):
    prog, ref = _readings(tiny(cell, "bfloat16"), 5)
    numbers = core.compare(prog, ref)
    assert numbers["loss"][0] < 2e-3
    assert numbers["grad"][0] < 5e-2


def test_the_traffic_is_the_seeds_own(cell):
    b = tiny(cell)
    a = core.make_columns(b.traffic, b.config, 2, 8, 11, "cpu")
    c = core.make_columns(b.traffic, b.config, 2, 8, 11, "cpu")
    d = core.make_columns(b.traffic, b.config, 2, 8, 12, "cpu")
    assert all((x == y).all() for x, y in zip(a, c))
    assert not (a[0] == d[0]).all()
    # the same sizes for every seed
    assert [x.shape for x in a] == [x.shape for x in d]
    p = core.make_params({"w": (4, 3), "ln.weight": (3,), "b": (3,)},
                         2 ** 33 + 1, "cpu")
    assert (p["ln.weight"] == 1).all() and (p["b"] == 0).all()
