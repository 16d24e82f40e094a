"""``collective``: the resident path of the distributed trainers,
``LocalSGDEngine.run_epoch_resident``, which
``DistributedTrainer._train_collective`` takes when the data fits on the
card. The engine is built as ``_train_collective`` builds it, from the
public trainer the cell names (``ADAG``, ``DynSGD``, …) through its
``_loss_step()``, ``allocate_optimizer()`` and ``allocate_merge_rule()``.
One epoch walks the staged rows window by window, unshuffled (the
trainers' default)."""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

from portbench import core
from portbench.drivers import common


def faults(bench) -> tuple:
    """The faults this path can have (``portbench.faults``): a worker that
    steps on one row has no half to leave out."""
    names = ("unchanged", "half_batch", "merge_skipped")
    if int(bench.cell["trainer_kwargs"]["batch_size"]) < 2:
        names = tuple(n for n in names if n != "half_batch")
    return names


class _KeepRule:
    """In place of whatever rule the trainer allocated: leaves the center
    and the workers as they are."""

    def merge(self, center, workers, axis=None):
        return center, workers


@contextlib.contextmanager
def plant(name: str):
    """The fault ``name`` planted in the port for the ``with`` block."""
    from distkeras_tpu_torch import trainers
    from distkeras_tpu_torch.parallel.local_sgd import LocalSGDEngine

    if name == "unchanged":
        window_fn = LocalSGDEngine._window_fn

        def window(self, state, batch):
            return state, window_fn(self, state, batch)[1]

        patch = mock.patch.object(LocalSGDEngine, "_window_fn", window)
    elif name == "half_batch":
        make = trainers._make_loss_step

        def make_half(*args, **kwargs):
            step = make(*args, **kwargs)

            def half(params, nt, batch):
                n = batch[0].shape[0] // 2
                return step(params, nt, tuple(x[:n] for x in batch))

            return half

        patch = mock.patch.object(trainers, "_make_loss_step", make_half)
    elif name == "merge_skipped":
        init = LocalSGDEngine.__init__

        def init_keeping(self, *args, **kwargs):
            init(self, *args, **kwargs)
            self.rule = _KeepRule()

        patch = mock.patch.object(LocalSGDEngine, "__init__", init_keeping)
    else:
        raise ValueError(f"unknown fault {name!r}")
    with patch:
        yield


def tiny(bench) -> None:
    """The cell's trainer cut, in place, to a size the CPU's tests run in
    seconds: two rows a worker, two windows an epoch, one traced epoch."""
    tk = bench.cell["trainer_kwargs"]
    tk["batch_size"] = 2
    bench.traffic["rows_per_step"] = int(tk["num_workers"]) * 2
    bench.cell.update(windows_per_epoch=2, trace_epochs=1)


class Driver:
    def __init__(self, bench, seed: int, device):
        from distkeras_tpu_torch import trainers
        from distkeras_tpu_torch.parallel.local_sgd import LocalSGDEngine

        cell = bench.cell
        spec = common.build_spec(bench.config, bench.traffic)
        t = getattr(trainers, cell["trainer"])(spec, device=device,
                                               **cell["trainer_kwargs"])
        self.engine = LocalSGDEngine(
            spec=t.spec, loss_step=t._loss_step(),
            optimizer=t.allocate_optimizer(), rule=t.allocate_merge_rule(),
            device=t.device, num_workers=t.num_workers,
            window=t.communication_window, batch_size=t.batch_size,
            mesh=t.mesh)
        self.lead, self.window, self.batch = (
            t.num_workers, t.communication_window, t.batch_size)
        self.shapes = common.shapes(spec)
        dev = self.engine.device
        self.params0 = core.make_params(self.shapes, seed, dev)
        self.state = self.engine.init_state(self.params0,
                                            common.buffers(spec, dev))
        epoch = int(cell["windows_per_epoch"])
        self.checked, self.staged = common.pool(
            bench, seed, self.lead, self.window, self.batch, dev, epoch)
        self.counts = common.counts(
            bench, self.lead * epoch * self.window * self.batch, epoch)

    def first_steps(self) -> dict:
        losses = []
        for s, rows in enumerate(self.checked):
            self.state, loss = self.engine.run_epoch_resident(
                self.state, rows, None)
            losses.append(loss)
            if s == 0:
                grad = core.leaf_norms(self.state.opt_state["mu"])
        change = core.leaf_norms({n: c - self.params0[n]
                                  for n, c in self.state.center.items()})
        del self.checked, self.params0
        return {"loss": torch.cat(losses).tolist(), "grad": grad,
                "change": change}

    def epoch(self) -> None:
        self.state, _ = self.engine.run_epoch_resident(self.state,
                                                       self.staged, None)

    def release(self) -> None:
        del self.engine, self.state, self.staged
        common.free()
