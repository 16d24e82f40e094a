"""``MeshTrainer`` over gloo worlds of several ranks on the CPU, brought up
by ``job_deployment.LocalRunner`` (``tests/torch_mesh_ranks.py`` a rank),
held against the JAX package's single-device plain step and against the
port's own world of one.

One 4-rank world runs dp×tp 2×2 (Megatron), fsdp 4, fsdp+megatron 2×2,
dp 4 with ``grad_accum`` 2 and dp 4 with explicit ``param_specs``, and
holds a 2-rank mesh in it to its refusal; one
2-rank world runs a dp×tp 1×2 save of the process-sharded ``.dks`` and
its resume. The same 4-rank world trains the GQA LM with RoPE and the
fused cross-entropy on dp×tp 2×2 (Megatron and fsdp+megatron).
Tolerances (f32): against
the JAX oracle as ``test_torch_mesh.py`` (parameters 2e-5 absolute,
losses 1e-5 relative, Adam ``eps=1e-3``); against the port's world of one
2e-6 absolute (the same math with the sums in another order); the
resumed run equals the uninterrupted one within 2e-6 (the sharded save
round-trips the state exactly, the collectives reorder sums).
"""

import numpy as np
import pytest

from distkeras_tpu_torch.parallel.fsdp import fsdp_specs
from tests.test_torch_mesh import (
    BATCH,
    LOSS_RTOL,
    PARAM_TOL,
    ROWS,
    SELF_TOL,
    assert_params_match,
    classifier_cfg,
    data,
    init_inputs,
    jax_init,
    jax_plain_train,
    lm_cfg,
    port_spec,
    run_world,
    train_case,
    world_of_one,
)

SPMD = {
    "dp2_tp2": dict(mesh_shape={"dp": 2, "tp": 2}),
    "fsdp4": dict(mesh_shape={"dp": 4}, parameter_sharding="fsdp"),
    "fsdp2_tp2": dict(mesh_shape={"dp": 2, "tp": 2},
                      parameter_sharding="fsdp+megatron"),
    "dp4_accum2": dict(mesh_shape={"dp": 4}, grad_accum=2),
    # explicit param_specs: every leaf split over dp (fsdp_specs at
    # min_size 0), biases and norms too
    "dp4_param_specs": dict(mesh_shape={"dp": 4}),
}
#: the GQA LM (2 kv heads over tp 2: one k and one v head a rank), its
#: vocab-parallel embedding and the fused cross-entropy over the
#: replicated head
LM = {
    "lm_dp2_tp2": dict(mesh_shape={"dp": 2, "tp": 2}),
    "lm_fsdp2_tp2": dict(mesh_shape={"dp": 2, "tp": 2},
                         parameter_sharding="fsdp+megatron"),
}
RESUME = dict(mesh_shape={"dp": 1, "tp": 2},
              parameter_sharding="fsdp+megatron", num_epoch=2)


@pytest.fixture(scope="module")
def setup():
    cfg = classifier_cfg()
    d = data()
    jp, jnt, tp = jax_init(cfg)
    return cfg, d, tp, jax_plain_train(cfg, jp, jnt, d, ROWS // BATCH)


@pytest.fixture(scope="module")
def lm_setup(setup):
    cfg = lm_cfg()
    d = setup[1]
    jp, jnt, tp = jax_init(cfg)
    return cfg, tp, jax_plain_train(cfg, jp, jnt, d, ROWS // BATCH)


@pytest.fixture(scope="module")
def world4(setup, lm_setup, tmp_path_factory):
    cfg, d, tp, _ = setup
    specs = fsdp_specs(tp, 4, min_size=0)
    assert any(s == ("dp",) for s in specs.values())
    cases = [train_case(n, cfg, "init", **kw) for n, kw in SPMD.items()]
    cases[-1]["trainer"]["param_specs"] = specs
    lcfg, ltp, _ = lm_setup
    cases += [train_case(n, lcfg, "lm", **kw) for n, kw in LM.items()]
    cases.append({"kind": "mesh_size", "name": "dp2_of_4",
                  "mesh": {"dp": 2}, "model": cfg})
    return run_world(4, cases, {**d, **init_inputs("init", tp),
                                **init_inputs("lm", ltp)},
                     tmp_path_factory.mktemp("world4"))


@pytest.fixture(scope="module")
def world2(setup, tmp_path_factory):
    cfg, d, tp, _ = setup
    cases = [train_case("full", cfg, "init", **RESUME),
             {**train_case("resumed", cfg, "init", **RESUME), "resume": 1}]
    return run_world(2, cases, {**d, **init_inputs("init", tp)},
                     tmp_path_factory.mktemp("world2"))


def _params(out):
    return {k[2:]: v for k, v in out.items() if k.startswith("p/")}


@pytest.mark.parametrize("case", sorted(SPMD))
def test_four_ranks_equal_the_jax_plain_step(setup, world4, case):
    cfg, _, _, (want_p, want_l) = setup
    out = world4[case]
    np.testing.assert_allclose(out["losses"], want_l, rtol=LOSS_RTOL)
    assert_params_match(_params(out), want_p, port_spec(cfg).module,
                        PARAM_TOL)


@pytest.fixture(scope="module")
def one_rank(setup):
    """The port's own single-rank run of the same steps: every layout's
    math at one rank."""
    cfg, d, tp, _ = setup
    return world_of_one(cfg, tp, d, mesh_shape={"dp": 1})


@pytest.mark.parametrize("case", sorted(SPMD))
def test_four_ranks_equal_the_ports_world_of_one(one_rank, world4, case):
    want, want_l = one_rank
    got = _params(world4[case])
    np.testing.assert_allclose(world4[case]["losses"], want_l, rtol=1e-6)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=SELF_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("case", sorted(LM))
def test_four_ranks_train_the_gqa_lm_as_the_jax_plain_step(lm_setup, world4,
                                                           case):
    cfg, _, (want_p, want_l) = lm_setup
    out = world4[case]
    np.testing.assert_allclose(out["losses"], want_l, rtol=LOSS_RTOL)
    assert_params_match(_params(out), want_p, port_spec(cfg).module,
                        PARAM_TOL)


def test_a_mesh_smaller_than_the_world_raises_on_every_rank(world4):
    """A 2-rank mesh in the 4-rank world raises at construction (ranks
    outside it would otherwise skip the world's collectives and hang the
    rest); the world then runs on, so no rank was left waiting."""
    out = world4["dp2_of_4"]
    for name in ("mesh", "trainer"):
        assert str(out[name]) == ("mesh {'dp': 2} spans 2 of the world's 4 "
                                  "ranks; a mesh takes every rank"), name


def test_two_rank_dks_resume_equals_the_uninterrupted_run(world2):
    full, resumed = world2["full"], world2["resumed"]
    files = [str(f) for f in resumed["files"]]
    assert any(f.endswith(".meta.dks") for f in files), files
    assert any(f.endswith(".p00001of00002.dks") for f in files), files
    for k, v in _params(full).items():
        np.testing.assert_allclose(_params(resumed)[k], v, rtol=0,
                                   atol=SELF_TOL, err_msg=k)
    np.testing.assert_allclose(resumed["losses"],
                               full["losses"][len(full["losses"]) // 2:],
                               rtol=1e-6)


def test_job_renders_the_cluster_environment_and_ssh_commands():
    """``Job`` hands every host the coordinator's address, the world size
    and its rank (what ``cluster_args_from_env`` reads back), and
    ``SSHRunner`` renders one ssh client argv a host without running it."""
    import shlex

    from distkeras_tpu.job_deployment import Job as JJob
    from distkeras_tpu.job_deployment import Punchcard as JPunchcard
    from distkeras_tpu_torch.job_deployment import (
        Job,
        Punchcard,
        SSHRunner,
        cluster_args_from_env,
    )

    kw = dict(script="train.py", hosts=["h0", "h1"], coordinator_port=9000,
              env={"X": "1"}, args=["--epochs", "2"])
    cmds = Job(Punchcard(**kw)).run()
    assert cmds == JJob(JPunchcard(**kw)).run()
    env = dict(t.split("=", 1) for t in shlex.split(cmds[1][1])[:4])
    import os

    old = dict(os.environ)
    try:
        os.environ.update(env)
        assert cluster_args_from_env() == {
            "coordinator_address": "h0:9000", "num_processes": 2,
            "process_id": 1}
    finally:
        os.environ.clear()
        os.environ.update(old)
    seen = []
    runner = SSHRunner(user="u", port=2222, transport=seen.append)
    Job(Punchcard(**kw), runner=runner).run()
    assert [a[:2] for a in seen] == [["ssh", "-o"]] * 2
    assert seen[1][-2:] == ["u@h1", cmds[1][1]] and "-p" in seen[1]
