"""Port parity of the training side and of sampled decode: Llama's
``loss_fn`` and ``make_train_step``, MoE (``route``, ``forward``, the
train step), the GPipe stages of ``parallel/pipeline.py``, and
``llama.generate`` with temperature — against ``demodel_tpu`` on the
CPU.

Weights and inputs are made once in numpy from a seed and carried across
(``params_from_numpy``); the JAX references are jitted. A train step's
loss, new params and new momentum agree within 1e-4 (the momentum, which
after one step from zeros is the gradient, relative to each leaf's
largest value), on the einsum path and through both packages' fused
attention (the Pallas kernel interpreted under ``jax.grad``, the port's
``FlashAttention`` over the kernel's plain version: one forward per layer
a step, a recompute in the backward). MoE routing is exact in integers
(dispatch equal, combine within 1e-6); the pipeline equals sequential
execution and the JAX schedule within 1e-5, gradients too. Sampled
tokens are never compared across packages (``jax.random`` and
``torch.multinomial`` are different RNGs): greedy is exact, equal
generators draw equal tokens, and draw frequencies pass a chi-square
test against the softmax.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from demodel_tpu.models import llama as jl
from demodel_tpu.models import moe as jmoe
from demodel_tpu.parallel import pipeline as jpipe
from demodel_tpu_torch.models import convert
from demodel_tpu_torch.models import llama as tl
from demodel_tpu_torch.models import moe as tmoe
from demodel_tpu_torch.ops import flash_attention as tfa
from demodel_tpu_torch.parallel import Mesh, make_mesh
from demodel_tpu_torch.parallel import pipeline as tpipe
from demodel_tpu_torch.utils.metrics import HUB, labeled
from demodel_tpu_torch.utils.tree import leaves

torch.set_num_threads(1)

TOL = 1e-4
ROUTE_TOL = 1e-6
PIPE_TOL = 1e-5
#: chi-square tests pass above this p-value
P_MIN = 1e-3


def _numpy_tree(shapes, seed: int):
    """numpy float32 leaves of the shapes in ``shapes`` (a tree of
    ``jax.ShapeDtypeStruct``): embeddings N(0, 0.02²), other matrices
    N(0, 1/fan_in) (fan_in the second-to-last dim), vectors (norms) near
    1."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        if len(s.shape) == 1:
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name == "embed":
            a = 0.02 * rng.standard_normal(s.shape)
        else:
            a = rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _models(jmod, tmod, cfg_j, cfg_t, seed):
    shapes = jax.eval_shape(lambda: jmod.init_params(jax.random.key(0),
                                                     cfg_j))
    tree = _numpy_tree(shapes, seed)
    return (jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, cfg_t, device="cpu"))


def _pairs(ttree, jtree) -> list:
    """(port leaf, reference leaf as numpy) pairs, matched by key."""
    if isinstance(ttree, dict):
        return [p for k in ttree for p in _pairs(ttree[k], jtree[k])]
    if isinstance(ttree, list):
        return [p for t, j in zip(ttree, jtree) for p in _pairs(t, j)]
    return [(ttree, np.asarray(jtree))]


def _assert_step(tout, jout):
    """One train step's (new_params, new_opt, loss) against the JAX
    package's: the loss and new params within TOL, the new momentum within
    TOL of each leaf's largest value."""
    (tp, to, tloss), (jp, jo, jloss) = tout, jout
    assert abs(float(tloss) - float(jloss)) <= TOL
    for t, j in _pairs(tp, jp):
        np.testing.assert_allclose(t.numpy(), j, rtol=TOL, atol=TOL)
    for t, j in _pairs(to, jo):
        assert np.abs(t.numpy() - j).max() <= TOL * max(np.abs(j).max(),
                                                         1.0)


@pytest.fixture(params=["einsum", "flash"])
def attn_path(request, monkeypatch):
    monkeypatch.setenv("DEMODEL_FLASH_ATTN",
                       "1" if request.param == "flash" else "0")
    return request.param


@pytest.fixture()
def k1_forwards(monkeypatch):
    """Counts K1's forwards (``_flash_forward``; its plain version on the
    CPU) — the calls that launch the kernel on the card."""
    calls = []
    inner = tfa._flash_forward

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return inner(*a, **kw)

    monkeypatch.setattr(tfa, "_flash_forward", counted)
    return calls


# ------------------------------------------------------------------ Llama


@pytest.fixture(scope="module")
def llama():
    jcfg, tcfg = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    jparams, tparams = _models(jl, tl, jcfg, tcfg, seed=11)
    tok = np.random.default_rng(12).integers(0, tcfg.vocab_size, (2, 13))
    return jparams, jcfg, tparams, tcfg, tok


def test_llama_loss_matches_jax(llama, attn_path):
    jparams, jcfg, tparams, tcfg, tok = llama
    want = jax.jit(jl.loss_fn, static_argnums=(2,))(jparams, jnp.asarray(tok),
                                                    jcfg)
    got = tl.loss_fn(tparams, torch.from_numpy(tok), tcfg)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert abs(got.item() - float(want)) <= TOL


def test_llama_train_step_matches_jax(llama, attn_path, k1_forwards):
    """Two steps (the second from a nonzero momentum); through flash, one
    K1 forward per layer a step and none in the backward."""
    jparams, jcfg, tparams, tcfg, tok = llama
    jinit, jstep = jl.make_train_step(jcfg)
    tinit, tstep = tl.make_train_step(tcfg)
    jstate, tstate = (jparams, jinit(jparams)), (tparams, tinit(tparams))
    for _ in range(2):
        jout = jstep(*jstate, jnp.asarray(tok))
        tout = tstep(*tstate, torch.from_numpy(tok))
        _assert_step(tout, jout)
        jstate, tstate = jout[:2], tout[:2]
    n = 2 * tcfg.num_hidden_layers if attn_path == "flash" else 0
    assert len(k1_forwards) == n
    # the momentum after step 1 is the gradient: it reached the
    # projections before attention
    assert tout[1]["layers"][0]["q_proj"].abs().sum() > 0


def test_llama_train_step_is_functional(llama):
    """The step returns new trees and leaves its inputs as they were;
    the momentum keeps each leaf's dtype (bf16 stays bf16)."""
    _, _, tparams, tcfg, tok = llama
    bf = convert.params_from_numpy(
        jax.tree.map(np.asarray, tparams), tcfg, device="cpu",
        dtype=torch.bfloat16)
    init, step = tl.make_train_step(tcfg)
    opt = init(bf)
    before = [t.clone() for t in leaves(bf)]
    p1, o1, loss = step(bf, opt, torch.from_numpy(tok))
    assert torch.isfinite(loss)
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(bf)))
    assert all(t.abs().sum() == 0 for t in leaves(opt))
    assert {t.dtype for t in leaves(p1) + leaves(o1)} == {torch.bfloat16}
    assert not any(t.requires_grad for t in leaves(p1) + leaves(o1))


# -------------------------------------------------------------------- MoE


ROUTE_CASES = {
    # tests/test_moe.py::test_route_invariants's shape
    "random": (lambda rng: rng.standard_normal((64, 4)), 32),
    "tight_capacity": (lambda rng: rng.standard_normal((64, 4)), 5),
    # every token prefers expert 0: arrival order decides who is served
    "overflow": (lambda rng: np.tile([10.0, 0, 0, 0], (16, 1)), 4),
    # exact ties: the first maximal expert, as jnp.argmax
    "ties": (lambda rng: np.tile([[1.0, 1.0, 0.0, 0.0], [0.0, 2.0, 2.0, 2.0]],
                                 (6, 1)), 3),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_matches_jax(case):
    make, capacity = ROUTE_CASES[case]
    logits = make(np.random.default_rng(1)).astype(np.float32)
    jc, jd = jmoe.route(jnp.asarray(logits), capacity)
    tc, td = tmoe.route(torch.from_numpy(logits), capacity)
    d = td.numpy()
    assert td.dtype == torch.bool and tc.dtype == torch.float32
    assert np.array_equal(d, np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)
    N = logits.shape[0]
    # tests/test_moe.py's invariants: one slot a token at most, one token
    # a slot at most, combine only where dispatch is, gates in (0, 1]
    assert (d.reshape(N, -1).sum(axis=1) <= 1).all()
    assert (d.sum(axis=0) <= 1).all()
    c = tc.numpy()
    assert ((c > 0) <= d).all()
    assert (c[c > 0] <= 1.0).all() and (c[c > 0] > 0).all()
    if case == "overflow":
        assert d[:, 0].sum() == 4 and d[:, 1:].sum() == 0
        assert d.reshape(N, -1).sum(axis=1)[:4].sum() == 4
    if case == "ties":
        assert set(np.argwhere(d.any(axis=2))[:, 1]) == {0, 1}


@pytest.fixture(scope="module")
def moe():
    jcfg, tcfg = jmoe.MoEConfig.tiny(), tmoe.MoEConfig.tiny()
    jparams, tparams = _models(jmoe, tmoe, jcfg, tcfg, seed=21)
    tok = np.random.default_rng(22).integers(0, tcfg.vocab_size, (2, 13))
    return jparams, jcfg, tparams, tcfg, tok


def test_moe_forward_matches_jax(moe):
    jparams, jcfg, tparams, tcfg, tok = moe
    want = jax.jit(jmoe.forward, static_argnums=(2,))(jparams,
                                                      jnp.asarray(tok), jcfg)
    got = tmoe.forward(tparams, torch.from_numpy(tok), tcfg)
    assert got.shape == (2, 13, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_moe_train_step_matches_jax(moe):
    jparams, jcfg, tparams, tcfg, tok = moe
    jinit, jstep = jmoe.make_train_step(jcfg)
    tinit, tstep = tmoe.make_train_step(tcfg)
    jout = jstep(jparams, jinit(jparams), jnp.asarray(tok))
    tout = tstep(tparams, tinit(tparams), torch.from_numpy(tok))
    _assert_step(tout, jout)
    # the experts and the router (through the gates) got a gradient
    assert tout[1]["layers"][0]["w_in"].abs().sum() > 0
    assert tout[1]["layers"][0]["router"].abs().sum() > 0


def test_moe_takes_one_device(moe):
    _, _, _, tcfg, _ = moe
    cpus = np.empty(2, dtype=object)
    cpus[:] = [torch.device("cpu")] * 2
    wide = Mesh(cpus.reshape(2, 1), ("ep", "tp"))
    for call in (lambda: tmoe.param_shardings(tcfg, wide),
                 lambda: tmoe.make_train_step(tcfg, wide)):
        with pytest.raises(NotImplementedError, match="A7"):
            call()
    specs = tmoe.param_shardings(tcfg, make_mesh(device="cpu"))
    assert specs["layers"][0]["w_in"] == ("ep", None, None)


# --------------------------------------------------------------- pipeline


DIM = 16


def _stages(n: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((DIM, DIM)) / DIM ** 0.5
                   ).astype(np.float32),
             "b": (0.1 * rng.standard_normal(DIM)).astype(np.float32)}
            for _ in range(n)]


def _jstage(p, a):
    return jnp.tanh(a @ p["w"] + p["b"])


def _tstage(p, a):
    return torch.tanh(a @ p["w"] + p["b"])


def _tstages(stages):
    return [{k: torch.from_numpy(v) for k, v in s.items()} for s in stages]


def test_microbatch_validates():
    x = torch.zeros((12, DIM))
    assert tpipe.microbatch(x, 4).shape == (4, 3, DIM)
    with pytest.raises(ValueError, match="divisible"):
        tpipe.microbatch(x, 5)
    with pytest.raises(ValueError, match="no stages"):
        tpipe.stack_stages([])


@pytest.mark.parametrize("n_stages,n_micro", [(2, 6), (4, 4), (4, 8)])
def test_pipeline_matches_sequential_and_jax(n_stages, n_micro):
    stages = _stages(n_stages, seed=n_stages + n_micro)
    x = np.random.default_rng(9).standard_normal(
        (n_micro * 2, DIM)).astype(np.float32)
    stacked = tpipe.stack_stages(_tstages(stages))
    got = tpipe.pipeline_apply(_tstage, stacked,
                               tpipe.microbatch(torch.from_numpy(x), n_micro))
    seq = torch.from_numpy(x)
    for s in _tstages(stages):
        seq = _tstage(s, seq)
    np.testing.assert_allclose(got.reshape(-1, DIM).numpy(), seq.numpy(),
                               rtol=PIPE_TOL, atol=PIPE_TOL)
    want = jax.jit(lambda st, xm: jpipe.pipeline_apply(_jstage, st, xm))(
        jpipe.stack_stages(jax.tree.map(jnp.asarray, stages)),
        jpipe.microbatch(jnp.asarray(x), n_micro))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PIPE_TOL,
                               atol=PIPE_TOL)


def test_pipeline_grads_match_sequential_and_jax():
    n_stages, n_micro = 4, 4
    stages = _stages(n_stages, seed=1)
    x = np.random.default_rng(2).standard_normal(
        (n_micro * 2, DIM)).astype(np.float32)
    xt = torch.from_numpy(x)
    stacked = {k: v.requires_grad_() for k, v in
               tpipe.stack_stages(_tstages(stages)).items()}
    (tpipe.pipeline_apply(_tstage, stacked, tpipe.microbatch(xt, n_micro))
     ** 2).mean().backward()
    seq_stages = [{k: v.requires_grad_() for k, v in s.items()}
                  for s in _tstages(stages)]
    a = xt
    for s in seq_stages:
        a = _tstage(s, a)
    (a ** 2).mean().backward()
    seq_grads = tpipe.stack_stages([{k: v.grad for k, v in s.items()}
                                    for s in seq_stages])

    def jloss(st):
        return (jpipe.pipeline_apply(_jstage, st, jpipe.microbatch(
            jnp.asarray(x), n_micro)) ** 2).mean()

    jgrads = jax.jit(jax.grad(jloss))(
        jpipe.stack_stages(jax.tree.map(jnp.asarray, stages)))
    for k, v in stacked.items():
        for want in (seq_grads[k].numpy(), np.asarray(jgrads[k])):
            np.testing.assert_allclose(v.grad.numpy(), want, rtol=PIPE_TOL,
                                       atol=PIPE_TOL)


def test_stages_stack_unstack_and_take_one_device():
    stages = _tstages(_stages(4, seed=3))
    stacked = tpipe.stack_stages(stages)
    assert stacked["w"].shape == (4, DIM, DIM)
    back = tpipe.unstack_stages(stacked, 4)
    assert all(torch.equal(b["w"], s["w"]) for b, s in zip(back, stages))
    assert tpipe.pipeline_stage_spec(3) == ("pp", None, None)
    placed = tpipe.shard_stages(stacked, make_mesh(device="cpu"))
    assert placed["w"].device.type == "cpu"
    cpus = np.empty(2, dtype=object)
    cpus[:] = [torch.device("cpu")] * 2
    wide = Mesh(cpus.reshape(2, 1), ("pp", "tp"))
    for call in (lambda: tpipe.shard_stages(stacked, wide),
                 lambda: tpipe.pipeline_apply(_tstage, stacked,
                                              torch.zeros(2, 1, DIM), wide)):
        with pytest.raises(NotImplementedError, match="A7"):
            call()


def test_gpipe_span_only_under_export_tracing(monkeypatch):
    """The ``compute.gpipe`` span (which synchronises the device) runs
    only with ``DEMODEL_TRACE`` set."""
    key = labeled("stage_duration_seconds", span="compute.gpipe")
    stacked = tpipe.stack_stages(_tstages(_stages(2, seed=4)))
    xmb = torch.zeros(2, 3, DIM)

    def count():
        h = HUB.histograms().get(key)
        return h["count"] if h else 0

    monkeypatch.delenv("DEMODEL_TRACE", raising=False)
    before = count()
    tpipe.pipeline_apply(_tstage, stacked, xmb)
    assert count() == before
    monkeypatch.setenv("DEMODEL_TRACE", "1")
    tpipe.pipeline_apply(_tstage, stacked, xmb)
    assert count() == before + 1


# ------------------------------------------------------- sampled decode


def test_generate_temperature_zero_is_greedy(llama):
    jparams, jcfg, tparams, tcfg, tok = llama
    prompt = tok[0, :7].tolist()
    want = np.asarray(jl.generate(jparams, jcfg, prompt, 5))[0].tolist()
    greedy = tl.generate(tparams, tcfg, prompt, 5)
    gen = torch.Generator().manual_seed(1)
    at_zero = tl.generate(tparams, tcfg, prompt, 5, temperature=0.0,
                          generator=gen)
    assert greedy[0].tolist() == at_zero[0].tolist() == want


def test_generate_equal_generators_draw_equal_tokens(llama):
    _, _, tparams, tcfg, tok = llama
    prompt = tok[:, :6]
    runs = [tl.generate(tparams, tcfg, prompt, 8, temperature=1.0,
                        generator=torch.Generator().manual_seed(s))
            for s in (5, 5)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (2, 8)
    assert ((runs[0] >= 0) & (runs[0] < tcfg.vocab_size)).all()
    # the default generator is seeded too
    assert torch.equal(*(tl.generate(tparams, tcfg, prompt, 4,
                                     temperature=0.8) for _ in range(2)))


def _chi2_p(counts: np.ndarray, probs: np.ndarray) -> float:
    """p-value of observed ``counts`` against ``probs``; categories
    expected fewer than 5 times are pooled into one."""
    n = counts.sum()
    exp = probs * n
    small = exp < 5
    obs = np.append(counts[~small], counts[small].sum())
    exp = np.append(exp[~small], exp[small].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    return float(stats.chisquare(obs, exp * n / exp.sum()).pvalue)


def test_sample_frequencies_match_the_softmax():
    """20,000 seeded draws from one fixed logit row at temperature 0.7."""
    row = np.random.default_rng(31).standard_normal(12).astype(np.float32)
    n, temp = 20_000, 0.7
    last = torch.from_numpy(row).expand(n, -1)
    draws = tl.sample(last, temp, torch.Generator().manual_seed(32))
    counts = np.bincount(draws.numpy(), minlength=row.size)
    probs = torch.softmax(torch.from_numpy(row) / temp, -1).double().numpy()
    assert _chi2_p(counts, probs) > P_MIN
    assert tl.sample(last[:3], 0.0).tolist() == [int(row.argmax())] * 3


def test_generate_first_draws_match_the_prefill_softmax(llama):
    """4,000 copies of one prompt: ``generate``'s first sampled tokens
    follow the softmax of the prompt's last logits over the temperature."""
    _, _, tparams, tcfg, tok = llama
    n, temp = 4000, 0.8
    prompt = np.repeat(tok[:1, :5], n, axis=0)
    first = tl.generate(tparams, tcfg, prompt, 1, temperature=temp,
                        generator=torch.Generator().manual_seed(33))[:, 0]
    last = tl.forward(tparams, torch.from_numpy(tok[:1, :5]), tcfg)[0, -1]
    probs = torch.softmax(last.double() / temp, -1).numpy()
    counts = np.bincount(first.numpy(), minlength=tcfg.vocab_size)
    assert _chi2_p(counts, probs) > P_MIN
