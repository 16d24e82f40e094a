"""``MeshTrainer(strategy=...)`` and the strategy libraries
(``parallel/{sequence,expert,pipeline,strategies}.py``) over one gloo world
of 4 ranks (``tests/torch_mesh_ranks.py`` a rank, launched by
``job_deployment.LocalRunner``), held against the JAX package's
single-device oracles on the same seeded inputs:

- ring: ``ring_attention`` over sp 4 (plain, causal with a key mask,
  windowed with a key mask) against ``attention_reference`` and its
  ``jax.vjp``: outputs and q/k/v gradients within 2e-5 absolute;
  ``strategy="sequence"`` on sp 4 (also with ``remat=True``, whose
  recompute runs the ring again) and dp 2 × sp 2 (a causal, windowed
  classifier with padding) against the plain step;
- expert: ``moe_mlp`` over ep 4 against the JAX package's own ``moe_mlp``
  on a 4-device ``ep`` mesh (output, aux and gradients within 2e-5), and
  ``strategy="expert"`` on dp 2 × ep 2 against the plain step of the
  single-device MoE model (no token dropped at the default capacity
  factor; ``aux_weight=0``, because the load-balancing loss is a mean
  over the routing shards and so depends on how many there are);
- pipeline: ``pipeline_apply`` on pp 4 against ``sequential_apply`` (1e-5),
  ``strategy="pipeline"`` on pp 4 (depth 4) and pp 2 × dp 2 (depth 2),
  with 2 microbatches, against the plain step.

Trainer runs: 4 Adam steps (``eps=1e-3``, see ``test_torch_mesh.py``),
parameters within 2e-5 absolute and losses within 1e-5 relative of the
JAX oracle, and within 2e-6 of the port's world of one where one exists
(pipeline, sequence).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distkeras_tpu.parallel.expert import moe_mlp as jmoe_mlp
from distkeras_tpu.parallel.sequence import attention_reference as jattn
from distkeras_tpu.parallel.tensor import get_mesh_nd
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
    moe_cfg,
    port_spec,
    run_world,
    train_case,
    world_of_one,
)

RING_TOL = 2e-5
SEQ_CFG = classifier_cfg(causal=True, attn_window=6)
DEEP_CFG = classifier_cfg(depth=4)
RING_CASES = {
    "ring_plain": dict(causal=False),
    "ring_causal_mask": dict(causal=True, mask=True),
    "ring_window_mask": dict(causal=False, window=5, mask=True),
}
TRAIN = {
    "seq_sp4": (SEQ_CFG, "seq", dict(mesh_shape={"sp": 4},
                                     strategy="sequence")),
    "seq_dp2_sp2": (SEQ_CFG, "seq", dict(mesh_shape={"dp": 2, "sp": 2},
                                         strategy="sequence")),
    "seq_sp4_remat": ({**SEQ_CFG, "remat": True}, "seq",
                      dict(mesh_shape={"sp": 4}, strategy="sequence")),
    "expert_dp2_ep2": (moe_cfg(), "moe", dict(mesh_shape={"dp": 2, "ep": 2},
                                              strategy="expert",
                                              aux_weight=0.0)),
    "pipe_pp4": (DEEP_CFG, "deep", dict(mesh_shape={"pp": 4},
                                        strategy="pipeline",
                                        microbatches=2)),
    "pipe_pp2_dp2": (classifier_cfg(), "base",
                     dict(mesh_shape={"pp": 2, "dp": 2},
                          strategy="pipeline", microbatches=2)),
}
MOE = dict(top_k=2, capacity_factor=2.0)


def _ring_inputs(rng):
    B, Lr, H, D = 2, 16, 2, 8
    mk = lambda: rng.normal(size=(B, Lr, H, D)).astype(np.float32)
    mask = np.ones((B, Lr), np.float32)
    mask[0, 11:] = 0.0
    mask[1, :3] = 0.0
    return {"rq": mk(), "rk": mk(), "rv": mk(), "rg": mk(), "rmask": mask}


def _moe_inputs(rng):
    from distkeras_tpu.parallel.expert import init_moe_params

    p = init_moe_params(rng, 8, 16, 4, scale=0.2)
    out = {f"mlp/{k}": v for k, v in p.items()}
    out["mx"] = rng.normal(size=(32, 8)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def oracles():
    d = data()
    out = {}
    for tag, cfg in (("seq", SEQ_CFG), ("moe", moe_cfg()),
                     ("deep", DEEP_CFG), ("base", classifier_cfg())):
        jp, jnt, tp = jax_init(cfg)
        out[tag] = (cfg, tp, jax_plain_train(cfg, jp, jnt, d,
                                             ROWS // BATCH))
    return d, out


@pytest.fixture(scope="module")
def world(oracles, tmp_path_factory):
    d, ors = oracles
    rng = np.random.default_rng(7)
    inputs = {**d, **_ring_inputs(rng), **_moe_inputs(rng),
              "pw": rng.normal(size=(4, 6, 6)).astype(np.float32) * 0.5,
              "px": rng.normal(size=(8, 6)).astype(np.float32)}
    for tag, (_, tp, _) in ors.items():
        inputs.update(init_inputs(tag, tp))
    cases = [{"kind": "ring", "name": n, "mesh": {"sp": 4}, "axis": "sp",
              **kw} for n, kw in RING_CASES.items()]
    cases.append({"kind": "moe", "name": "moe_ep4", "mesh": {"ep": 4},
                  "axis": "ep", **MOE})
    cases.append({"kind": "pipeline_apply", "name": "pipeline_apply_pp4",
                  "mesh": {"pp": 4}, "axis": "pp", "microbatches": 4})
    cases += [train_case(n, cfg, tag, **kw)
              for n, (cfg, tag, kw) in TRAIN.items()]
    return inputs, run_world(4, cases, inputs,
                             tmp_path_factory.mktemp("world4s"))


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_attention_equals_attention_reference(world, case):
    inputs, out = world
    kw = RING_CASES[case]
    mask = jnp.asarray(inputs["rmask"]) if kw.get("mask") else None
    f = lambda q, k, v: jattn(q, k, v, causal=kw["causal"], key_mask=mask,
                              window=kw.get("window"))
    y, vjp = jax.vjp(f, *(jnp.asarray(inputs[n])
                          for n in ("rq", "rk", "rv")))
    grads = vjp(jnp.asarray(inputs["rg"]))
    got = out[case]
    np.testing.assert_allclose(got["out"], np.asarray(y), rtol=0,
                               atol=RING_TOL)
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(got[name], np.asarray(g), rtol=0,
                                   atol=RING_TOL, err_msg=name)


def test_moe_mlp_over_ep4_equals_the_jax_packages(world):
    inputs, out = world
    params = {k: jnp.asarray(inputs[f"mlp/{k}"])
              for k in ("gate", "w1", "b1", "w2", "b2")}
    x = jnp.asarray(inputs["mx"])
    mesh = get_mesh_nd({"ep": 4}, devices=jax.devices()[:4])

    def obj(p, x):
        y, aux = jmoe_mlp(p, x, mesh, axis="ep", **MOE)
        return jnp.mean(y ** 2) + 0.01 * aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        obj, argnums=(0, 1), has_aux=True))(params, x)
    got = out["moe_ep4"]
    np.testing.assert_allclose(got["y"], np.asarray(y), rtol=0,
                               atol=RING_TOL)
    np.testing.assert_allclose(got["aux"], np.asarray(aux), rtol=1e-6)
    for k, g in {**gp, "x": gx}.items():
        np.testing.assert_allclose(got[f"g/{k}"], np.asarray(g), rtol=0,
                                   atol=RING_TOL, err_msg=k)


def test_pipeline_apply_equals_sequential_apply(world):
    import torch

    from distkeras_tpu_torch.parallel.pipeline import sequential_apply

    inputs, out = world
    w = torch.from_numpy(inputs["pw"]).requires_grad_(True)
    stage = lambda p, act: (torch.tanh(act[0] @ p["w"]),)
    (y,) = sequential_apply(stage, {"w": w},
                            (torch.from_numpy(inputs["px"]),))
    (gw,) = torch.autograd.grad(torch.sum(y ** 2), (w,))
    got = out["pipeline_apply_pp4"]
    np.testing.assert_allclose(got["y"], y.detach().numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["gw"], gw.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", sorted(TRAIN))
def test_strategy_equals_the_jax_plain_step(oracles, world, case):
    _, ors = oracles
    cfg, tag, _ = TRAIN[case]
    _, _, (want_p, want_l) = ors[tag]
    got = world[1][case]
    params = {k[2:]: v for k, v in got.items() if k.startswith("p/")}
    np.testing.assert_allclose(got["losses"], want_l, rtol=LOSS_RTOL)
    assert_params_match(params, want_p, port_spec(cfg).module, PARAM_TOL)


@pytest.mark.parametrize("case", ["seq_sp4", "pipe_pp2_dp2"])
def test_strategy_equals_the_ports_world_of_one(oracles, world, case):
    d, ors = oracles
    cfg, tag, kw = TRAIN[case]
    kw = {**kw, "mesh_shape": {k: 1 for k in kw["mesh_shape"]}}
    if kw["strategy"] == "pipeline":
        kw.update(strategy="spmd", microbatches=None)
    want, want_l = world_of_one(cfg, ors[tag][1], d, **kw)
    got = world[1][case]
    np.testing.assert_allclose(got["losses"], want_l, rtol=1e-6)
    for k, v in want.items():
        np.testing.assert_allclose(got[f"p/{k}"], v, rtol=0, atol=SELF_TOL,
                                   err_msg=k)
