"""The port's parallelism example
(``python -m distkeras_tpu_torch.examples.parallelism``, the twin of
``examples/parallelism.py``).

- ``make_task`` is bit-equal to the JAX example's (the tasks every demo
  trains on).
- ``--quick --device cpu`` in a gloo world of 2, started through
  ``job_deployment.Job`` + ``LocalRunner`` as a user would start it: every
  demo runs over the world with its mesh derived from the world size as the
  JAX example derives it from its device count (dp: ADAG with a worker a
  rank; tp 1×2; fsdp 2; pp 2 stages; sp 2 ranks at L=32; ep dp=2 × ep=1),
  prints its tag, and each MeshTrainer's loss falls (rank 0's records,
  ``--records``).
- A world of one in this process (``main`` with no launcher): the six
  records.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest

from distkeras_tpu_torch.examples import parallelism as twin
from tests.test_torch_mesh import free_port, one_world_at_a_time

REPO = pathlib.Path(__file__).resolve().parent.parent
TAGS = ("[dp]", "[tp]", "[fsdp]", "[pp]", "[sp]", "[ep]")


@pytest.fixture(scope="module")
def jax_example():
    """``examples/parallelism.py`` as a module; its import-time
    ``KERAS_BACKEND`` default is set and then restored."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KERAS_BACKEND", "jax")
        spec = importlib.util.spec_from_file_location(
            "jax_parallelism_example", REPO / "examples" / "parallelism.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,maxlen", [(256, 16), (128, 32)])
def test_make_task_is_the_jax_examples(jax_example, n, maxlen):
    got = twin.make_task(np.random.default_rng(0), n, maxlen=maxlen)
    want = jax_example.make_task(np.random.default_rng(0), n, maxlen=maxlen)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_quick_run_in_a_world_of_two(tmp_path):
    from distkeras_tpu_torch.job_deployment import Job, LocalRunner, Punchcard

    env = {"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1"}
    runner = LocalRunner()
    with one_world_at_a_time():
        job = Job(Punchcard(
            script=str(REPO / "distkeras_tpu_torch" / "examples"
                       / "parallelism.py"),
            hosts=["localhost"] * 2, coordinator_port=free_port(), env=env,
            args=["--quick", "--device", "cpu", "--records",
                  str(tmp_path / "records.json")]), runner=runner)
        try:
            job.run()
            rcs = runner.wait(timeout=240.0)
        finally:
            for p in runner.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)
    out = [getattr(p, "captured_stdout", "") for p in runner.procs]
    err = "\n".join(getattr(p, "captured_stderr", "")[-3000:]
                    for p in runner.procs)
    assert rcs == [0, 0], err
    assert out[0].startswith("devices: 2 × cpu"), out[0]
    for tag in TAGS:
        assert tag in out[0], (tag, out[0])
    for tag, mesh in (("[tp]", "dp=1×tp=2"), ("[pp]", "dp=1×pp=2"),
                      ("[sp]", "dp=1×sp=2, L=32"), ("[ep]", "dp=2×ep=1")):
        assert f"{tag} MeshTrainer" in out[0] and mesh in out[0], (tag, out)
    recs = json.loads((tmp_path / "records.json").read_text())
    assert list(recs) == ["dp", "tp", "fsdp", "pp", "sp", "ep"]
    _losses_fall(recs)


def _losses_fall(recs):
    """Each MeshTrainer's step losses are finite and their second half's
    mean is below their first half's (single steps at batch 32 are noisy:
    a last step may sit above a first)."""
    for name in ("tp", "fsdp", "pp", "sp", "ep"):
        losses = np.asarray(recs[name]["losses"])
        half = len(losses) // 2
        assert np.all(np.isfinite(losses)), (name, losses)
        assert losses[half:].mean() < losses[:half].mean(), (name, losses)


def test_quick_run_in_a_world_of_one():
    recs = twin.main(["--quick", "--device", "cpu"])
    assert list(recs) == ["dp", "tp", "fsdp", "pp", "sp", "ep"]
    assert 0.0 <= recs["dp"]["acc"] <= 1.0
    _losses_fall(recs)
