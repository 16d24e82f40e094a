"""The multi-process parameter server (``backend="ps"`` in a world of
several ranks): a 2-rank gloo world on the CPU, brought up by
``job_deployment.LocalRunner`` (``tests/torch_mesh_ranks.py`` a rank),
trains DOWNPOUR on label-sorted rows over the socket and the native
transports, as ``tests/test_multihost.py::
test_two_process_ps_backend_through_trainer_api`` trains the JAX package.

Rank 0 hosts the server, each rank runs two hogwild worker threads with
ids offset by its rank, over the strided row split (each rank sees both
classes). The gates are the JAX test's: both ranks return the same center
(checksums gathered in the world), every loss is finite, each rank
records 64 window losses (2 workers × 16 windows × 2 epochs) and the mean
of the last 8 is below the first. Hogwild order is not deterministic, so
no parameter is compared with a one-process run. Every refusal of the
JAX package's multi-process path raises in the port with the same
message: the messages are compared from the two functions' source, and
the world raises each of them.
"""

import ast
import inspect
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest

from distkeras_tpu import trainers as jtrainers
from distkeras_tpu.datasets import higgs
from distkeras_tpu.models import mlp as jmlp
from distkeras_tpu_torch import trainers as ttrainers
from distkeras_tpu_torch.convert import tensors_from_jax
from distkeras_tpu_torch.models import mlp as tmlp
from tests.test_torch_mesh import init_inputs, run_world

MLP = dict(input_shape=(28,), hidden=(32, 16), num_classes=2)
TRAIN = dict(worker_optimizer="sgd", learning_rate=0.02, num_workers=4,
             batch_size=16, communication_window=2, num_epoch=2, seed=3)


def _inputs():
    import jax

    train, _ = higgs(n_train=2048, n_test=64)
    p, _ = jax.jit(jmlp(dtype=jnp.float32, **MLP).init)(
        jax.random.PRNGKey(0))
    tp = tensors_from_jax(jax.tree.map(np.asarray, p),
                          tmlp(**MLP).module)
    return {"x": np.asarray(train["features"], np.float32),
            "y": np.asarray(train["label"], np.int32),
            **init_inputs("mlp", {k: v.float().numpy()
                                  for k, v in tp.items()})}


def _case(name, **kw):
    return {"kind": "ps_train", "name": name, "init": "mlp",
            "model": {"kind": "mlp", **MLP}, "sorted": True,
            "trainer": {**TRAIN, **kw}}


#: each refusal of the JAX package's path, as a trainer's kwargs
REFUSALS = {
    "workers": dict(num_workers=3),
    "checkpoint": dict(checkpoint_dir="ck"),
    "ema": dict(ema_decay=0.9),
    "ps_host": dict(ps_transport="socket", ps_host="10.0.0.1"),
    "shards": dict(ps_num_shards=2),
    "directory": dict(ps_transport="socket", directory=True),
}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    trials = {k: {"what": "ps", "num_workers": 2, **v}
              for k, v in REFUSALS.items()}
    cases = [_case("socket", ps_transport="socket"),
             _case("native", ps_transport="native"),
             {"kind": "refuse", "name": "refuse", "init": "mlp",
              "model": {"kind": "mlp", **MLP}, "trials": trials}]
    return run_world(2, cases, _inputs(), tmp_path_factory.mktemp("ps2"),
                     timeout=240.0)


@pytest.mark.parametrize("transport", ["socket", "native"])
def test_two_ranks_train_one_center(world2, transport):
    out = world2[transport]
    a, b = out["checksums"]
    assert a == b, "ranks returned different centers"
    losses = out["losses"]
    assert np.isfinite(losses).all()
    assert len(losses) == 64, len(losses)
    assert np.mean(losses[-8:]) < losses[0]
    # worker ids offset by rank · W_local
    assert [list(i) for i in out["ids"]] == [[0, 1], [2, 3]]
    # the strided split hands both ranks both classes of sorted rows
    assert [list(c) for c in out["labels"]] == [[0, 1], [0, 1]]


def _refusals(fn) -> list:
    """``(exception, message template)`` of every ``raise`` in ``fn``:
    adjacent literals joined, each f-string field written ``{}``."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Raise) and isinstance(node.exc,
                                                           ast.Call)):
            continue
        arg = node.exc.args[0]
        parts = arg.values if isinstance(arg, ast.JoinedStr) else [arg]
        text = "".join(p.value if isinstance(p, ast.Constant) else "{}"
                       for p in parts)
        out.append((node.exc.func.id, text))
    return out


def test_refusal_messages_are_the_jax_packages():
    want = _refusals(jtrainers.DistributedTrainer._train_ps_multiprocess)
    got = _refusals(ttrainers.DistributedTrainer._train_ps_multiprocess)
    assert len(want) == 6
    assert got == want


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_each_refusal_raises_in_the_world(world2, name):
    msg = str(world2["refuse"][name])
    templates = _refusals(
        jtrainers.DistributedTrainer._train_ps_multiprocess)
    heads = [f"{cls}: {text.split('{}')[0]}" for cls, text in templates]
    assert any(msg.startswith(h) for h in heads), msg
