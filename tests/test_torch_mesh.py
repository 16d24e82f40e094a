"""The port's mesh layer (``distkeras_tpu_torch/parallel/{mesh,tensor,fsdp}
.py``, ``MeshTrainer``, the ``.dks`` format) held against the JAX package
on the CPU, and the helpers the multi-process mesh tests share.

- ``megatron_specs``, ``fsdp_specs`` (``min_size`` 0 and 2048, alone and
  over Megatron) and ``expert_specs`` equal the JAX package's leaf by
  leaf: a JAX spec over flax's ``kernel [in, out]`` read in the port's
  ``weight [out, in]`` layout through the weight bridge.
- A world of one (the mesh makes it itself, gloo here) trains every
  ``parameter_sharding`` and ``grad_accum`` through ``MeshTrainer``; its
  losses and parameters after 4 Adam steps equal the JAX package's
  single-device plain step (``tests/test_tensor_parallel.py::
  _plain_step``'s recipe) in f32: parameters within 2e-5 absolute, losses
  within 1e-5 relative. Adam runs with ``eps=1e-3`` in both packages: the
  k part of the fused qkv bias has a zero gradient in exact arithmetic
  (softmax ignores a constant added to a row's scores), and Adam with a
  tiny ``eps`` would blow each package's rounding noise there up to a
  full step of either sign.
- ``.dkc`` save and resume in one process equals the uninterrupted run
  (0, bit-equal); the port reads a ``.dks`` the JAX package's
  ``_save_sharded`` wrote on the fake 8-device mesh (values equal, 0).
- ``MeshTrainer``'s validation errors carry the JAX class's messages.
"""

import contextlib
import functools
import json
import os
import socket
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distkeras_tpu.models import moe_transformer_classifier as jmoe
from distkeras_tpu.models import transformer_classifier as jclassifier
from distkeras_tpu.models import transformer_lm as jlm
from distkeras_tpu.models.moe import moe_aux_loss as jmoe_aux_loss
from distkeras_tpu.ops.losses import sparse_softmax_cross_entropy as jce
from distkeras_tpu.parallel.fsdp import fsdp_specs as jfsdp_specs
from distkeras_tpu.parallel.strategies import expert_specs as jexpert_specs
from distkeras_tpu.parallel.tensor import megatron_specs as jmegatron_specs
from distkeras_tpu_torch import checkpoint as tckpt
from distkeras_tpu_torch.convert import params_to_jax, tensors_from_jax
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import lm as tlm
from distkeras_tpu_torch.models import (
    moe_transformer_classifier as tmoe,
    transformer_classifier as tclassifier,
)
from distkeras_tpu_torch.parallel import fsdp as tfsdp
from distkeras_tpu_torch.parallel import mesh as tmesh
from distkeras_tpu_torch.parallel import tensor as ttensor
from distkeras_tpu_torch.parallel.strategies import expert_specs
from distkeras_tpu_torch.trainers import MeshTrainer

REPO = Path(__file__).resolve().parents[1]
RANKS = Path(__file__).resolve().parent / "torch_mesh_ranks.py"

V, L, C, DIM, HEADS = 64, 16, 4, 32, 4
ROWS, BATCH = 32, 8
LR, EPS = 3e-3, 1e-3
PARAM_TOL, LOSS_RTOL = 2e-5, 1e-5
#: the port's multi-rank runs against its own world of one: the same math,
#: sums in another order
SELF_TOL = 2e-6


# -- shared helpers -------------------------------------------------------------

def classifier_cfg(**kw):
    return {**dict(kind="classifier", vocab=V, maxlen=L, dim=DIM,
                   heads=HEADS, depth=2, num_classes=C), **kw}


def moe_cfg(**kw):
    return {**dict(kind="moe", vocab=V, maxlen=L, dim=DIM, heads=HEADS,
                   depth=2, num_experts=4, top_k=2, capacity_factor=2.0,
                   num_classes=C), **kw}


def lm_cfg(**kw):
    """A GQA causal LM with RoPE and the fused cross-entropy (config 9's
    composition at a toy width)."""
    return {**dict(kind="lm", vocab=V, maxlen=L, dim=DIM, heads=HEADS,
                   depth=2, kv_heads=2, pos_embedding="rope", fused_ce=True,
                   ce_chunk=8), **kw}


def jax_spec(cfg):
    cfg = dict(cfg)
    kind = cfg.pop("kind")
    fn = {"classifier": jclassifier, "moe": jmoe, "lm": jlm}[kind]
    return fn(dtype=jnp.float32, **cfg)


def port_spec(cfg):
    cfg = dict(cfg)
    kind = cfg.pop("kind")
    fn = {"classifier": tclassifier, "moe": tmoe,
          "lm": tlm.transformer_lm_spec}[kind]
    return fn(dtype=torch.float32, **cfg)


def data(seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, V, size=(ROWS, L)).astype(np.int32)
    mask = np.ones((ROWS, L), np.float32)
    mask[:, L - 4:] = 0.0   # a padded tail exercises the key mask
    mask[::3, L - 7:] = 0.0
    label = rng.integers(0, C, size=ROWS).astype(np.int32)
    stream = ((rng.integers(0, V, (ROWS, 1)) + np.arange(L + 1)[None])
              % V).astype(np.int32)
    return {"tokens": toks, "mask": mask, "label": label,
            "lm_tokens": stream[:, :-1], "lm_label": stream[:, 1:]}


@functools.lru_cache(maxsize=None)
def _jax_init(key: str):
    cfg = json.loads(key)
    # jitted: flax's op-by-op init takes seconds; the values are
    # ``init_np(0)``'s
    jp, jnt = jax.tree.map(np.asarray, jax.jit(jax_spec(cfg).init)(
        jax.random.PRNGKey(0)))
    tp = tensors_from_jax(jp, port_spec(cfg).module)
    return jp, jnt, {k: v.numpy() for k, v in tp.items()}


def jax_init(cfg):
    """The JAX init (numpy tree, seed 0) and the same weights as port
    arrays, by the name of the port's leaves."""
    return _jax_init(json.dumps(cfg, sort_keys=True))


def jax_plain_train(cfg, jp, jnt, d, steps, aux_weight=0.0):
    """The single-device oracle: ``steps`` Adam steps over consecutive
    batches, unshuffled; ``(params, losses)``."""
    spec = jax_spec(cfg)
    tx = optax.adam(LR, eps=EPS)

    lm = cfg["kind"] == "lm"

    def loss(p, toks, mask, y):
        if cfg["kind"] == "moe":
            logits, aux = jmoe_aux_loss(spec.module, p, (toks, mask))
            return jce(y, logits) + aux_weight * aux
        out, _ = spec.apply(p, jnt, toks if lm else (toks, mask), True)
        return jce(y, out)

    @jax.jit
    def step(p, o, toks, mask, y):
        l, g = jax.value_and_grad(loss)(p, toks, mask, y)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, l

    toks, lab = (("lm_tokens", "lm_label") if lm else ("tokens", "label"))
    p, o, losses = jp, tx.init(jp), []
    for s in range(steps):
        sl = slice(s * BATCH, (s + 1) * BATCH)
        p, o, l = step(p, o, d[toks][sl], d["mask"][sl], d[lab][sl])
        losses.append(float(l))
    return jax.tree.map(np.asarray, p), np.array(losses)


def assert_params_match(port: dict, jax_tree, module, tol):
    want = {k: v.numpy() for k, v in tensors_from_jax(jax_tree,
                                                      module).items()}
    assert set(port) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(port[k]), want[k], rtol=0,
                                   atol=tol, err_msg=k)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def one_world_at_a_time():
    """Hold a lock that every test process takes around its world, so
    the suite's parallel workers run one gloo world at a time: its ranks
    on top of the other workers would crowd the cores that the suite's
    timing tests read."""
    import fcntl
    import tempfile

    path = Path(tempfile.gettempdir()) / "distkeras_torch_mesh_world.lock"
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def run_world(n: int, cases: list, inputs: dict, workdir: Path,
              timeout: float = 150.0) -> dict:
    """Start ``n`` gloo ranks of ``torch_mesh_ranks.py`` through
    ``job_deployment.LocalRunner``, run ``cases`` and return rank 0's
    results by case name. Every process is waited for or killed."""
    from distkeras_tpu_torch.job_deployment import Job, LocalRunner, Punchcard

    workdir.mkdir(parents=True, exist_ok=True)
    np.savez(workdir / "inputs.npz", **inputs)
    (workdir / "plan.json").write_text(json.dumps({"cases": cases}))
    env = {"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1"}
    runner = LocalRunner()
    with one_world_at_a_time():
        job = Job(Punchcard(script=str(RANKS), hosts=["localhost"] * n,
                            coordinator_port=free_port(), env=env,
                            args=[str(workdir)]), runner=runner)
        try:
            job.run()
            rcs = runner.wait(timeout=timeout)
        finally:
            for p in runner.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)
    if any(rcs):
        errs = "\n".join(getattr(p, "captured_stderr", "")[-3000:]
                         for p in runner.procs)
        raise AssertionError(f"ranks exited {rcs}:\n{errs}")
    return {c["name"]: dict(np.load(workdir / f"{c['name']}.npz"))
            for c in cases}


def init_inputs(prefix: str, port_params: dict) -> dict:
    return {f"{prefix}/{k}": v for k, v in port_params.items()}


def train_case(name, cfg, init, **trainer):
    return {"kind": "train", "name": name, "model": cfg, "init": init,
            "batch": BATCH, "lr": LR, "eps": EPS, "trainer": trainer}


@contextlib.contextmanager
def one_thread():
    """torch on one thread for the toy runs of this process: under the
    suite's parallel workers, the default of a thread a core makes their
    tiny ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def world_of_one(cfg, port_init: dict, d, **trainer):
    """The port's own world of one through ``MeshTrainer``: ``(params,
    losses)``."""
    import dataclasses

    spec = port_spec(cfg)
    _, state = spec.init(0)
    init = {k: torch.from_numpy(v) for k, v in port_init.items()}
    spec = dataclasses.replace(spec, init=lambda s: (init, state))
    from distkeras_tpu_torch import optim

    epochs = trainer.pop("num_epoch", 1)
    t = MeshTrainer(spec, worker_optimizer=optim.adam(LR, eps=EPS),
                    features_col=["features", "mask"], batch_size=BATCH,
                    num_epoch=epochs, device="cpu", **trainer)
    try:
        cols = {"features": d["tokens"], "mask": d["mask"],
                "label": d["label"]}
        with one_thread():
            params = t.train(Dataset(cols))
    finally:
        t.close()
    losses = np.array([r["loss"] for r in t.history.records if "loss" in r])
    return {k: v.numpy() for k, v in params.items()}, losses


# -- specs ----------------------------------------------------------------------

def _spec_in_port_layout(jspec_tree, port_params: dict, module) -> dict:
    """A JAX spec tree over flax leaves, read per port leaf: each port
    leaf's ids pass through ``params_to_jax`` to find its flax leaf and
    whether the bridge transposed it."""
    sizes = np.cumsum([0] + [v.size for v in port_params.values()])
    ids = {k: (np.arange(v.size) + off).reshape(v.shape).astype(np.float64)
           for (k, v), off in zip(port_params.items(), sizes)}
    jtree = params_to_jax({k: torch.from_numpy(v) for k, v in ids.items()},
                          module)
    flat_ids = jax.tree_util.tree_flatten_with_path(jtree)[0]
    flat_spec = dict((jax.tree_util.keystr(p), s) for p, s in
                     jax.tree_util.tree_flatten_with_path(
                         jspec_tree, is_leaf=lambda x: isinstance(x, P))[0])
    out = {}
    for path, arr in flat_ids:
        name = next(k for k, v in ids.items() if v.flat[0] == arr.flat[0])
        spec = tuple(flat_spec[jax.tree_util.keystr(path)])
        spec = spec + (None,) * (arr.ndim - len(spec))
        if not np.array_equal(arr, ids[name]):
            assert np.array_equal(arr, ids[name].T), name
            spec = spec[::-1]
        out[name] = spec
    return out


def _port_full(specs: dict, params: dict) -> dict:
    return {k: tmesh.full_spec(specs[k], np.ndim(params[k]))
            for k in params}


#: the spec tests' models: the classifier, the MoE classifier, the GQA LM
SPEC_MODELS = (classifier_cfg(), moe_cfg(), lm_cfg(fused_ce=False))


def _model(k):
    """``(jax params, port params, port module)`` of ``SPEC_MODELS[k]``."""
    jp, _, tp = jax_init(SPEC_MODELS[k])
    return jp, tp, port_spec(SPEC_MODELS[k]).module


@pytest.mark.parametrize("k", range(3))
def test_megatron_specs_equal_the_jax_packages_leaf_by_leaf(k):
    jp, tp, module = _model(k)
    want = _spec_in_port_layout(jmegatron_specs(jp), tp, module)
    got = _port_full(ttensor.megatron_specs(tp), tp)
    assert got == want
    assert any("tp" in s for s in got.values())


@pytest.mark.parametrize("min_size", [0, 2048])
@pytest.mark.parametrize("megatron", [False, True])
@pytest.mark.parametrize("k", range(3))
def test_fsdp_specs_equal_the_jax_packages_leaf_by_leaf(k, megatron,
                                                       min_size):
    jp, tp, module = _model(k)
    jbase = jmegatron_specs(jp) if megatron else None
    tbase = ttensor.megatron_specs(tp) if megatron else None
    want = _spec_in_port_layout(
        jfsdp_specs(jp, 4, base_specs=jbase, min_size=min_size), tp, module)
    got = _port_full(tfsdp.fsdp_specs(tp, 4, base_specs=tbase,
                                      min_size=min_size), tp)
    assert got == want


def test_expert_specs_equal_the_jax_packages_leaf_by_leaf():
    jp, tp, module = _model(1)
    want = _spec_in_port_layout(jexpert_specs(jp), tp, module)
    assert _port_full(expert_specs(tp), tp) == want


# -- layouts --------------------------------------------------------------------

class _FakeMesh:
    """Coordinates of one rank on a named mesh, for the pure layout maths."""

    def __init__(self, shape, index):
        self.shape, self._index = dict(shape), dict(index)
        self.axis_names = tuple(shape)

    def size(self, a):
        return self.shape.get(a, 1) if a is not None else 1

    def index(self, a):
        return self._index.get(a, 0) if a is not None else 0


def test_qkv_is_held_head_wise_and_pieces_rebuild_the_global_leaf():
    """Under tp the fused qkv rows of rank r are q's, k's and v's head
    slice r (a GQA split too); the pieces of every rank, pasted at their
    global starts, rebuild the global leaf exactly once."""
    g = np.arange(2 * (8 + 4 + 4) * 6, dtype=np.float32).reshape(32, 6)
    sizes = (16, 8, 8)
    shape = {"dp": 3, "tp": 2}
    for spec in [("tp", None), ("tp", "dp")]:
        rebuilt = np.zeros_like(g)
        count = np.zeros_like(g)
        for d in range(3):
            for t in range(2):
                lay = tmesh.LeafLayout(g.shape, spec,
                                         _FakeMesh(shape, {"dp": d, "tp": t}),
                                         qkv=sizes)
                local = lay.local(torch.from_numpy(g))
                cols = slice(2 * d, 2 * d + 2) if spec[1] else slice(None)
                want = np.concatenate([g[0 + 8 * t:8 + 8 * t],
                                       g[16 + 4 * t:20 + 4 * t],
                                       g[24 + 4 * t:28 + 4 * t]])[:, cols]
                np.testing.assert_array_equal(local.numpy(), want)
                for starts, block in lay.pieces(local):
                    region = tuple(slice(s, s + n)
                                   for s, n in zip(starts, block.shape))
                    if lay.writes() or spec[1]:
                        rebuilt[region] = block
                        count[region] += 1
        np.testing.assert_array_equal(rebuilt, g)
        assert count.min() >= 1


def test_assert_param_shardings_reads_each_ranks_local_shapes():
    """The test helper passes the pieces ``LeafLayout`` places (the qkv
    head split included) and names a leaf whose shape is not its
    spec's."""
    params = {"blocks.0.qkv.weight": np.zeros((96, 32), np.float32),
              "blocks.0.attn_out.weight": np.zeros((32, 32), np.float32),
              "ln_head.weight": np.zeros(32, np.float32)}
    specs = ttensor.megatron_specs(params)
    shapes = {k: v.shape for k, v in params.items()}
    mesh = _FakeMesh({"dp": 2, "tp": 4}, {"dp": 1, "tp": 3})
    local = {k: tmesh.LeafLayout(v.shape, specs[k], mesh,
                                 qkv=(32, 32, 32) if "qkv" in k else None)
             .local(torch.from_numpy(v)) for k, v in params.items()}
    ttensor.assert_param_shardings(local, specs, mesh, shapes)
    assert tuple(local["blocks.0.qkv.weight"].shape) == (24, 32)
    local["blocks.0.attn_out.weight"] = torch.zeros(32, 32)
    with pytest.raises(AssertionError, match="attn_out"):
        ttensor.assert_param_shardings(local, specs, mesh, shapes)


# -- a world of one against the JAX plain step ----------------------------------

SPMD_CASES = {
    "megatron": dict(mesh_shape={"dp": 1, "tp": 1}),
    "fsdp": dict(mesh_shape={"dp": 1}, parameter_sharding="fsdp"),
    "fsdp+megatron": dict(mesh_shape={"dp": 1, "tp": 1},
                          parameter_sharding="fsdp+megatron"),
    "grad_accum": dict(mesh_shape={"dp": 1}, grad_accum=2),
    "stream": dict(mesh_shape={"dp": 1}, input_mode="stream"),
}


@pytest.fixture(scope="module")
def plain_oracle():
    cfg = classifier_cfg()
    d = data()
    jp, jnt, tp = jax_init(cfg)
    return cfg, d, tp, jax_plain_train(cfg, jp, jnt, d, ROWS // BATCH)


@pytest.mark.parametrize("case", sorted(SPMD_CASES))
def test_world_of_one_equals_the_jax_plain_step(plain_oracle, case):
    cfg, d, tp, (want_p, want_l) = plain_oracle
    params, losses = world_of_one(cfg, tp, d, **SPMD_CASES[case])
    np.testing.assert_allclose(losses, want_l, rtol=LOSS_RTOL)
    assert_params_match(params, want_p, port_spec(cfg).module, PARAM_TOL)


def test_dkc_resume_equals_the_uninterrupted_run(plain_oracle, tmp_path):
    cfg, d, tp, _ = plain_oracle
    kw = dict(mesh_shape={"dp": 1, "tp": 1},
              parameter_sharding="fsdp+megatron")
    full, full_l = world_of_one(cfg, tp, d, num_epoch=2, **kw)
    ck = str(tmp_path / "ck")
    world_of_one(cfg, tp, d, num_epoch=1, checkpoint_dir=ck, **kw)
    assert any(f.endswith(".dkc") for f in os.listdir(ck))
    resumed, res_l = world_of_one(cfg, tp, d, num_epoch=2,
                                  checkpoint_dir=ck, resume=True, **kw)
    for k in full:
        np.testing.assert_array_equal(resumed[k], full[k], err_msg=k)
    np.testing.assert_array_equal(res_l, full_l[len(full_l) // 2:])


# -- the JAX package's .dks -----------------------------------------------------

def test_the_port_reads_a_dks_the_jax_package_wrote(tmp_path, monkeypatch):
    """``_save_sharded`` of the JAX package on the fake 8-device mesh (a
    dp×tp-sharded param tree, an optax state, an epoch) loads through the
    port with every value equal and origin "jax"."""
    from distkeras_tpu import checkpoint as jckpt
    from distkeras_tpu.parallel.tensor import get_mesh_nd, shard_pytree
    from jax.experimental import multihost_utils

    jp, _ = jax_spec(classifier_cfg()).init_np(0)
    mesh = get_mesh_nd({"dp": 2, "tp": 4})
    sharded = shard_pytree(jp, mesh, jmegatron_specs(jp))
    opt = optax.adam(1e-3).init(jp)
    tree = {"params": sharded, "opt": opt, "epoch": 3}
    monkeypatch.setattr(multihost_utils, "sync_global_devices",
                        lambda name: None)
    jckpt._save_sharded(tmp_path, tree, step=3)
    assert any(f.endswith(".meta.dks") for f in os.listdir(tmp_path))
    got, step, origin = tckpt.load_checkpoint(tmp_path)
    assert (step, origin) == (3, "jax")
    assert int(np.asarray(got["epoch"])) == 3
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = got["params"]
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf)
    mu = got["opt"][0][1]
    assert set(mu) == set(jp)
    # MeshTrainer resumes only the port's own: the optax moments map onto
    # no state of the port's optimizers
    t = MeshTrainer(port_spec(classifier_cfg()), device="cpu",
                    mesh_shape={"dp": 1}, checkpoint_dir=str(tmp_path),
                    resume=True, features_col=["features", "mask"])
    try:
        d = data()
        with pytest.raises(ValueError, match="written by the JAX package"):
            t.train(Dataset({"features": d["tokens"], "mask": d["mask"],
                             "label": d["label"]}))
    finally:
        t.close()


def test_stages_from_jax_is_the_ports_pipeline_layout():
    """The bridge carries the JAX package's pipeline engine layout
    (``split_pipeline_params``: the blocks stacked on ``[S]``) onto the
    port's ``stages.…`` layout, equal to splitting the bridged model
    params (exact)."""
    from distkeras_tpu.parallel.strategies import (
        split_pipeline_params as jsplit,
    )
    from distkeras_tpu_torch.convert import stages_from_jax
    from distkeras_tpu_torch.parallel.strategies import (
        join_pipeline_params,
        split_pipeline_params,
    )

    cfg = classifier_cfg(depth=3)
    jp, _, tp = jax_init(cfg)
    module = port_spec(cfg).module
    got = stages_from_jax(jsplit(jp, 3), module)
    want = split_pipeline_params(
        {k: torch.from_numpy(v) for k, v in tp.items()}, 3)
    assert set(got) == set(want)
    assert got["stages.qkv.weight"].shape == (3, 3 * DIM, DIM)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    back = join_pipeline_params(got, 3)
    for k, v in tp.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


# -- validation -----------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(strategy="tensor"),
    dict(parameter_sharding="zero"),
    dict(strategy="pipeline", parameter_sharding="fsdp"),
    dict(input_mode="lazy"),
])
def test_mesh_trainer_validation_errors_match_the_jax_class(kw):
    from distkeras_tpu import MeshTrainer as JMeshTrainer

    with pytest.raises(ValueError) as jerr:
        JMeshTrainer(jax_spec(classifier_cfg()), **kw)
    with pytest.raises(ValueError) as terr:
        MeshTrainer(port_spec(classifier_cfg()), device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)
    assert not torch.distributed.is_initialized()


def test_a_mesh_larger_than_the_world_raises():
    from distkeras_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="needs 4 ranks"):
        Mesh({"dp": 2, "tp": 2}, device="cpu")
    with Mesh({"dp": 1}, device="cpu") as m:
        assert m.owns_world and torch.distributed.get_world_size() == 1
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            Mesh({"dp": 2}, device="cpu")
    assert not torch.distributed.is_initialized()


def test_ema_validation_and_metrics_through_a_world_of_one(plain_oracle):
    """``ema_decay=0`` keeps the EMA equal to the parameters (the JAX
    test's pin); ``validation_data`` scores every epoch with the params of
    that epoch (the last equals the validator run on the returned params);
    ``log_metrics`` records throughput an epoch."""
    import dataclasses

    from distkeras_tpu_torch import optim

    cfg, d, tp, _ = plain_oracle
    spec = port_spec(cfg)
    _, state = spec.init(0)
    init = {k: torch.from_numpy(v) for k, v in tp.items()}
    spec = dataclasses.replace(spec, init=lambda s: (init, state))
    cols = {"features": d["tokens"], "mask": d["mask"], "label": d["label"]}
    val = Dataset({k: v[:12] for k, v in cols.items()})
    t = MeshTrainer(spec, worker_optimizer=optim.adam(LR, eps=EPS),
                    features_col=["features", "mask"], batch_size=BATCH,
                    num_epoch=2, device="cpu", mesh_shape={"dp": 1, "tp": 1},
                    ema_decay=0.0, validation_data=val, log_metrics=True)
    try:
        with one_thread():
            params = t.train(Dataset(cols))
    finally:
        t.close()
    for k in params:
        np.testing.assert_array_equal(t.ema_params_[k].numpy(),
                                      params[k].numpy())
    vals = [r for r in t.metrics_ if "val_loss" in r]
    assert [r["epoch"] for r in vals] == [0, 1]
    assert all("samples_per_sec" in r for r in t.metrics_
               if "val_loss" not in r)
    from distkeras_tpu_torch.trainers import _Validator

    again = _Validator(spec, t.loss_fn, val, ["features", "mask"], "label",
                       BATCH, torch.device("cpu"))(params, t.trained_nt_)
    np.testing.assert_allclose(vals[-1]["val_loss"], again["val_loss"],
                               rtol=1e-6)
