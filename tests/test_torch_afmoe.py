"""AFMoE (Trinity) on the CPU at the benchmark's tiny cut
(``portbench/tests/tiny/trinity_mini.json`` over
``portbench/configs/trinity_mini.json``): the port's model
(``models/afmoe.py``) and its dropless expert layer
(``parallel/expert.py``, ``ops/moe_gemm.py``'s plain versions) against the
plain reference (``portbench/reference/afmoe.py``), the held-expert share
against the uncut layer, routing skewed onto one expert, the ``vmap``
rule, NoPE and the band, and the tracer."""

from __future__ import annotations

import json
import os
import unittest.mock as mock

import pytest
import torch
import torch.nn.functional as F

from distkeras_tpu_torch import models
from distkeras_tpu_torch.models import afmoe
from distkeras_tpu_torch.observability import trace as ttrace
from distkeras_tpu_torch.ops import moe_gemm
from distkeras_tpu_torch.parallel import expert
from portbench.reference import afmoe as ref
from portbench.reference.numerics import matmul

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "portbench", "configs",
                       "trinity_mini.json")) as _f:
    CONFIG = json.load(_f)
with open(os.path.join(ROOT, "portbench", "tests", "tiny",
                       "trinity_mini.json")) as _f:
    TINY = json.load(_f)
L = int(TINY["traffic"]["length"])
F32 = matmul("f32")


def _kw(**over):
    return {**CONFIG["kwargs"], **TINY["kwargs"], **over}


def _spec(dtype, **over):
    kw = _kw(**over)
    return models.afmoe_lm_spec(maxlen=L, **{**kw, "dtype": dtype}), kw


def _tokens(seed, rows=2):
    g = torch.Generator().manual_seed(seed)
    t = torch.randint(0, int(TINY["kwargs"]["vocab"]), (rows, L + 1),
                      generator=g)
    return t[:, :-1], t[:, 1:]


def _port(spec, p, s, x, y):
    """(logits, loss, grads) of the port: the fused loss's gradients."""
    pp = {n: v.clone().requires_grad_(True) for n, v in p.items()}
    loss, _ = spec.fused_losses["sparse_softmax_cross_entropy"](
        pp, s, x, y, True)
    grads = dict(zip(pp, torch.autograd.grad(loss, list(pp.values()))))
    logits = torch.func.functional_call(spec.module, {**p, **s}, (x,))
    return logits, loss.detach(), grads


def _reference(kw, p, x, y):
    pr = {n: v.clone().requires_grad_(True) for n, v in p.items()}
    loss = ref.loss(pr, x, y, {"kwargs": kw}, F32)
    grads = dict(zip(pr, torch.autograd.grad(loss, list(pr.values()))))
    with torch.no_grad():
        logits = ref.logits(p, x, {"kwargs": kw}, F32)
    return logits, loss.detach(), grads


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def test_port_matches_the_reference_in_f32():
    """Logits, loss and every parameter's gradient, f32 against f32: the
    same equations in another order of sums (flash's online softmax, the
    fused CE's chunks, the grouped products' masks), so within a few f32
    roundings."""
    spec, kw = _spec(torch.float32)
    p, s = spec.init(7)
    x, y = _tokens(1)
    lg, loss, grads = _port(spec, p, s, x, y)
    rlg, rloss, rgrads = _reference(kw, p, x, y)
    torch.testing.assert_close(lg, rlg, rtol=1e-5, atol=1e-5)
    assert abs(loss - rloss) <= 1e-6 * abs(rloss)
    assert set(grads) == set(rgrads)
    for n, g in grads.items():
        scale = rgrads[n].abs().max().item()
        assert (g - rgrads[n]).abs().max().item() <= 1e-5 * scale + 1e-12, n


def _norm_gap(a, b):
    return abs(a.float().norm() - b.float().norm()).item() / max(
        b.float().norm().item(), 1e-30)


@pytest.mark.parametrize("dense_layers,bounds", [
    # every FFN dense: bf16 products alone (8-bit significands, ~2e-3 a
    # rounding, over 4 layers and the head); QK-norm's scale gradients sum
    # products that cancel, so a leaf reads up to ~0.1 (measured on seeds
    # 7–11: logits 1.3–1.5e-2, loss ≤ 3.6e-4, leaves ≤ 0.1, leaf norms
    # ≤ 0.042)
    (4, dict(logits=3e-2, loss=1e-3, leaf=0.2, norm=0.1)),
    # the cut's pattern, one dense layer then experts: a near tie of two
    # experts' scores may round to the other pick and move that token's
    # output, and its gradient, by a whole expert's, so the gradient of a
    # leaf that few tokens reach (a router, an expert) can differ by about
    # itself; the leaf norms and the loss stay close (measured on seeds
    # 7–11: logits 3.3e-2–0.118, loss ≤ 1.6e-3, leaves ≤ 0.49, leaf norms
    # ≤ 0.22)
    (1, dict(logits=0.2, loss=5e-3, leaf=1.0, norm=0.3)),
])
def test_port_in_bf16_stays_near_the_f32_reference(dense_layers, bounds):
    """bf16 port against the f32 reference: logits (relative norm), loss,
    each gradient leaf (relative norm of the difference) and each leaf's
    norm (the benchmark's ``grad`` reading), within the bounds above."""
    spec, kw = _spec(torch.bfloat16, dense_layers=dense_layers)
    p, s = spec.init(7)
    x, y = _tokens(7)
    lg, loss, grads = _port(spec, p, s, x, y)
    rlg, rloss, rgrads = _reference(kw, p, x, y)
    assert _rel(lg, rlg) < bounds["logits"]
    assert abs(loss - rloss) < bounds["loss"] * abs(rloss)
    for n, g in grads.items():
        assert _rel(g, rgrads[n]) < bounds["leaf"], n
        assert _norm_gap(g, rgrads[n]) < bounds["norm"], n


def _weights(g, experts, d, f):
    r = lambda *s: torch.randn(*s, generator=g)
    return {"router": r(experts, d) * d ** -0.5,
            "experts_gate_up": r(experts, 2 * f, d) * d ** -0.5,
            "experts_down": r(experts, d, f) * f ** -0.5,
            "shared.gate_up.weight": r(2 * f, d) * d ** -0.5,
            "shared.down.weight": r(d, f) * f ** -0.5}


def _shared(x, w):
    g, u = (x @ w["shared.gate_up.weight"].t()).chunk(2, dim=-1)
    return (F.silu(g) * u) @ w["shared.down.weight"].t()


def test_held_shares_add_up_to_the_uncut_layer():
    """Eight experts over four shares of two: each share routes over all
    eight and computes its own experts' part; the four parts plus the
    shared expert, counted once, are the uncut reference layer."""
    g = torch.Generator().manual_seed(3)
    T, d, f, E, k = 40, 32, 16, 8, 3
    w = _weights(g, E, d, f)
    x = torch.randn(T, d, generator=g)
    idx, gw = expert.route_sigmoid_topk(x, w["router"], torch.zeros(E), k,
                                        2.826)
    parts = [expert.held_experts(x, idx, gw,
                                 w["experts_gate_up"][2 * i:2 * i + 2],
                                 w["experts_down"][2 * i:2 * i + 2],
                                 first=2 * i) for i in range(4)]
    want = ref.moe(x, w, "", {"top_k": k, "route_scale": 2.826}, F32)
    torch.testing.assert_close(sum(parts) + _shared(x, w), want, rtol=1e-5,
                               atol=1e-5)
    # a share that holds no picked expert contributes exactly zero
    none = expert.held_experts(x, torch.full_like(idx, 7), gw,
                               w["experts_gate_up"][:2],
                               w["experts_down"][:2], first=0)
    assert (none == 0).all()


def test_dropless_under_skew_matches_the_reference():
    """A router bias that sends every token's two picks to experts 1 and
    2: nothing is dropped (every token's output and gradient match the
    reference's loop), and the held experts 0 and 3 get no row, a zero
    output share and a zero gradient."""
    g = torch.Generator().manual_seed(5)
    T, d, f, E, k = 48, 32, 16, 8, 2
    mod = afmoe.MoE(d, f, E, 4, 0, k, 2.826, torch.float32, "cpu",
                    torch.float32)
    w = _weights(g, E, d, f)
    w["experts_gate_up"], w["experts_down"] = (w["experts_gate_up"][:4],
                                               w["experts_down"][:4])
    bias = torch.zeros(E)
    bias[1], bias[2] = 100.0, 50.0
    names = {"router": "router", "experts_gate_up": "experts_gate_up",
             "experts_down": "experts_down",
             "shared.gate_up.weight": "shared.gate_up.weight",
             "shared.down.weight": "shared.down.weight"}
    x = torch.randn(1, T, d, generator=g, requires_grad=True)
    params = {names[n]: v.clone().requires_grad_(True) for n, v in w.items()}
    out = torch.func.functional_call(mod, {**params, "expert_bias": bias},
                                     (x,))
    dy = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad((out * dy).sum(), [x, *params.values()])
    xr = x.detach().clone().requires_grad_(True)
    pr = {n: v.clone().requires_grad_(True) for n, v in w.items()}
    want = ref.moe(xr[0], {**pr, "expert_bias": bias}, "",
                   {"top_k": k, "route_scale": 2.826}, F32)
    exp = torch.autograd.grad((want * dy[0]).sum(), [xr, *pr.values()])
    torch.testing.assert_close(out[0], want, rtol=1e-5, atol=1e-5)
    for a, b in zip(got, exp):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    d_gu, d_down = got[2], got[3]
    for e in (0, 3):
        assert (d_gu[e] == 0).all() and (d_down[e] == 0).all()
    assert d_gu[1].abs().sum() > 0 and d_gu[2].abs().sum() > 0


def test_grouped_products_plain_versions_by_hand():
    """Uneven and empty groups, rows past the last group: each group's
    rows take its own weight, rows of no group are zero, an empty group's
    weight gradient is zero."""
    g = torch.Generator().manual_seed(2)
    counts = [3, 0, 5, 1]
    R, n, k = 12, 6, 4
    off = torch.tensor([0, 3, 3, 8, 9], dtype=torch.int32)
    x = torch.randn(R, k, generator=g)
    dy = torch.randn(R, n, generator=g)
    w = torch.randn(len(counts), n, k, generator=g)
    y, dx = moe_gemm.grouped_mm(x, w, off), moe_gemm.grouped_mm_dx(dy, w, off)
    dw = moe_gemm.grouped_mm_dw(x, dy, off)
    for gi in range(len(counts)):
        a, b = int(off[gi]), int(off[gi + 1])
        torch.testing.assert_close(y[a:b], x[a:b] @ w[gi].t())
        torch.testing.assert_close(dx[a:b], dy[a:b] @ w[gi])
        torch.testing.assert_close(dw[gi], dy[a:b].t() @ x[a:b])
    assert (y[9:] == 0).all() and (dx[9:] == 0).all() and (dw[1] == 0).all()


def test_vmap_rule_matches_a_loop_over_workers():
    """``vmap(grad)`` over three workers with their own tokens, routing
    and experts (the rule folds the workers into the expert groups)
    against one worker at a time: values and every gradient."""
    g = torch.Generator().manual_seed(4)
    W, T, d, f, E, held, k = 3, 20, 32, 16, 8, 4, 3
    xs = torch.randn(W, T, d, generator=g)
    wr = torch.randn(W, E, d, generator=g) * d ** -0.5
    gu = torch.randn(W, held, 2 * f, d, generator=g) * d ** -0.5
    dn = torch.randn(W, held, d, f, generator=g) * f ** -0.5
    bias = torch.zeros(W, E)

    def fn(x, wr, gu, dn, bias):
        idx, w = expert.route_sigmoid_topk(x, wr, bias, k, 2.0)
        y = expert.held_experts(x, idx, w, gu, dn, first=2)
        return (y.sin() ** 2).sum(), y

    step = torch.func.grad(fn, argnums=(0, 1, 2, 3), has_aux=True)
    grads, ys = torch.func.vmap(step)(xs, wr, gu, dn, bias)
    for i in range(W):
        gi, yi = step(xs[i], wr[i], gu[i], dn[i], bias[i])
        torch.testing.assert_close(ys[i], yi, rtol=1e-6, atol=1e-6)
        for a, b in zip(grads, gi):
            torch.testing.assert_close(a[i], b, rtol=1e-5, atol=1e-6)


def _attention(sliding, window=8):
    torch.manual_seed(0)
    att = afmoe.Attention(32, 4, 2, 8, sliding, window, 1e-5,
                          torch.float32, "flash", "cpu", torch.float32)
    with torch.no_grad():
        for prm in att.parameters():
            if prm.dim() > 1:
                prm.normal_(0, prm.shape[-1] ** -0.5)
    return att


def _rope(n, seed=None):
    if seed is None:
        inv = 10000.0 ** (-torch.arange(0, 8, 2) / 8)
        ang = torch.arange(n)[:, None] * inv[None]
    else:
        ang = torch.rand(n, 4, generator=torch.Generator().manual_seed(seed))
    return torch.cos(ang), torch.sin(ang)


def test_full_layers_are_nope_and_window_layers_banded():
    """A full layer reads no position table (NoPE: any table gives the
    same output) and its last query sees the first key; a sliding layer
    rotates (another table, another output) and a query sees no key
    ``window`` or more positions back."""
    n, window = 24, 8
    x = torch.randn(2, n, 32, generator=torch.Generator().manual_seed(1))
    x2 = x.clone()
    x2[:, 0] += 1.0
    full, band = _attention(False), _attention(True, window)
    with torch.no_grad():
        torch.testing.assert_close(full(x, _rope(n)), full(x, _rope(n, 3)))
        assert not torch.allclose(band(x, _rope(n)), band(x, _rope(n, 3)))
        moved = (full(x2, _rope(n)) - full(x, _rope(n))).abs().amax(
            dim=(0, 2))
        assert moved[-1] > 0
        moved = (band(x2, _rope(n)) - band(x, _rope(n))).abs().amax(
            dim=(0, 2))
        assert moved[window - 1] > 0 and (moved[window:] == 0).all()


def test_routing_path_makes_no_host_read_and_no_span_when_off():
    """With the tracer off, the expert layer (router, top-k, sort, the
    grouped products, combine) and its backward call no ``.item()``,
    ``.tolist()``, ``.cpu()`` or ``.numpy()`` and open no span."""
    assert not ttrace.enabled()
    spec, kw = _spec(torch.float32)
    p, s = spec.init(3)
    x, y = _tokens(4)
    moe = spec.module.blocks[-1].ffn
    h = torch.randn(2, L, int(kw["dim"]))
    forbid = lambda *a, **k: (_ for _ in ()).throw(AssertionError(
        "host read on the routing path"))
    made = []
    real = ttrace._Span

    def spy(*a, **k):
        made.append(a)
        return real(*a, **k)

    with mock.patch.object(torch.Tensor, "item", forbid), \
            mock.patch.object(torch.Tensor, "tolist", forbid), \
            mock.patch.object(torch.Tensor, "cpu", forbid), \
            mock.patch.object(torch.Tensor, "numpy", forbid), \
            mock.patch.object(ttrace, "_Span", spy):
        prm = {n: v.clone().requires_grad_(True)
               for n, v in moe.named_parameters()}
        out = torch.func.functional_call(
            moe, {**prm, **dict(moe.named_buffers())}, (h,))
        torch.autograd.grad(out.square().sum(), list(prm.values()))
    assert made == []


def test_tracer_on_records_the_spans_and_counts_once_a_window():
    """With the tracer on, the layer records ``moe.route``,
    ``moe.experts``, ``moe.combine`` and ``moe.backward``, and its counts
    reach the host once a window: the first call of a window emits the
    last window's ``moe.pairs`` (pairs a layer call) and
    ``moe.rows_max_over_mean``."""
    g = torch.Generator().manual_seed(6)
    T, d, f, E, k = 32, 32, 16, 8, 2
    w = _weights(g, E, d, f)
    x = torch.randn(T, d, generator=g, requires_grad=True)
    load = expert.ExpertLoad()
    ttrace.enable()
    try:
        with mock.patch.object(expert, "LOAD", load):
            held = []
            for corr in ("x0", "x0", "x1"):
                ttrace.set_corr(corr)
                idx, gw = expert.route_sigmoid_topk(
                    x, w["router"], torch.zeros(E), k, 1.0)
                held.append(int(((idx >= 2) & (idx < 6)).sum()))
                y = expert.held_experts(x, idx, gw,
                                        w["experts_gate_up"][2:6],
                                        w["experts_down"][2:6], first=2)
                torch.autograd.grad(y.sum(), x)
        evs = ttrace.events()
    finally:
        ttrace.disable()
    names = {e["name"] for e in evs}
    assert {"moe.route", "moe.experts", "moe.combine",
            "moe.backward"} <= names
    assert load.windows == 1 and load.calls == 2
    assert load.pairs == held[0] + held[1]
    pairs = [e for e in evs if e["name"] == "moe.pairs"]
    assert len(pairs) == 1 and pairs[0]["args"] == pytest.approx(
        (held[0] + held[1]) / 2)
    assert any(e["name"] == "moe.rows_max_over_mean" for e in evs)


def test_configuration_file_holds_the_cut_and_its_parameters():
    """The published widths beside the cut: ``kwargs`` repeat the
    published numbers ``afmoe_lm_spec`` takes, ``reduced`` names exactly the
    cut's three keys, and ``params`` is the built model's count (on the
    meta device: no memory)."""
    c, kw = CONFIG, CONFIG["kwargs"]
    assert c["reduced"] == ["depth", "experts_held", "vocab"]
    pairs = {"hidden_size": "dim", "num_attention_heads": "heads",
             "num_key_value_heads": "kv_heads", "head_dim": "head_dim",
             "intermediate_size": "mlp_dim", "num_experts": "experts",
             "moe_intermediate_size": "expert_dim",
             "num_experts_per_tok": "top_k", "route_scale": "route_scale",
             "sliding_window": "window", "rope_theta": "rope_theta",
             "rms_norm_eps": "rms_eps", "num_dense_layers": "dense_layers"}
    for pub, ours in pairs.items():
        assert kw[ours] == c[pub], pub
    assert kw["layer_types"] == c["layer_types"][:kw["depth"]]
    assert (c["depth"], c["experts_held"], c["vocab"]) == (
        kw["depth"], kw["experts_held"], kw["vocab"])
    assert c["vocab_size"] == 8 * c["vocab"]
    assert c["num_experts"] == 8 * c["experts_held"]
    assert c["num_hidden_layers"] == 4 * c["depth"]
    mod = afmoe.AfmoeLM(maxlen=16, **{
        n: v for n, v in kw.items()
        if n not in ("dtype", "attn_impl", "fused_ce", "ce_chunk")},
        attn_impl="flash", device="meta")
    assert sum(p.numel() for p in mod.parameters()) == c["params"]


def test_adag_windows_match_the_reference_in_f32():
    """The benchmark cell's timed path at the tiny cut in f32: ADAG, W=2,
    fused Adam, ``LocalSGDEngine.run_epoch_resident``, three windows
    against the reference's own windows from the same weights and rows
    (``portbench``'s comparison)."""
    from portbench import core, run
    from portbench.tests.conftest import tiny

    b = tiny("trinity_mini_adag_L8192", "float32")
    drv = core.load_driver(b.cell["driver"]).Driver(b, 2 ** 31 + 27, "cpu")
    prog = drv.first_steps()
    layout = dict(lead=drv.lead, window=drv.window, batch=drv.batch,
                  shapes=drv.shapes)
    drv.release()
    numbers = core.compare(prog, run.reference_readings(
        b, layout, 2 ** 31 + 27, "cpu"))
    assert numbers["loss"][0] < 1e-5
    assert numbers["grad"][0] < 1e-5
    assert numbers["change"][0] < 1e-3


def test_engine_window_keeps_its_input_and_reuses_its_own_buffers():
    """The collective engine's window with fused Adam's ``update.into``
    (updates over the gradients, from the second step on the moments and
    the workers overwritten in place) gives the same bits as the
    allocating ``update``, and leaves the state it was handed as it was
    (a fault that returns that state, or a checkpoint, may hold it)."""
    from distkeras_tpu_torch import trainers
    from distkeras_tpu_torch.parallel.local_sgd import LocalSGDEngine
    from distkeras_tpu_torch.utils import tree_leaves

    spec, _ = _spec(torch.float32)
    t = trainers.ADAG(spec, device="cpu", loss="sparse_softmax_cross_entropy",
                      worker_optimizer="fused_adam", learning_rate=1e-3,
                      num_workers=2, batch_size=1, communication_window=3,
                      features_col="features", label_col="label")
    opt = t.allocate_optimizer()
    assert callable(opt.update.into)
    plain = type(opt)(opt.init, lambda g, s, p=None: opt.update(g, s, p))
    toks = torch.randint(0, int(TINY["kwargs"]["vocab"]), (2, 3, 1, L + 1),
                         generator=torch.Generator().manual_seed(8))
    batch = (toks[..., :-1].contiguous(), toks[..., 1:].contiguous())
    out = []
    for tx in (opt, plain):
        eng = LocalSGDEngine(spec=spec, loss_step=t._loss_step(),
                             optimizer=tx, rule=t.allocate_merge_rule(),
                             device="cpu", num_workers=2, window=3,
                             batch_size=1)
        state = eng.init_state(*spec.init(5))
        before = [x.clone() for x in tree_leaves(
            {"w": state.workers, "m": state.opt_state["mu"],
             "v": state.opt_state["nu"], "c": state.center})]
        new, loss = eng.run_window(state, batch)
        after = tree_leaves({"w": state.workers, "m": state.opt_state["mu"],
                             "v": state.opt_state["nu"], "c": state.center})
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        out.append((new, loss))
    (a, la), (b, lb) = out
    assert torch.equal(la, lb)
    for x, y in zip(tree_leaves({"c": a.center, "w": a.workers,
                                 "m": a.opt_state["mu"]}),
                    tree_leaves({"c": b.center, "w": b.workers,
                                 "m": b.opt_state["mu"]})):
        assert torch.equal(x, y)
