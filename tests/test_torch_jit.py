"""The port's ``jit.TrainStep`` and ``TrainStep.accumulate`` against the JAX
package's, on the CPU.

A tiny Llama in fp32 gets the same numpy-drawn weights in both packages
(the JAX model's state carried across by ``llama_state_from_numpy``) and
the same seeded batches; the JAX package runs on its CPU backend, the port
its kernels' plain versions (on the CPU a step is eager whatever ``graph``
says; the graphed step's card tests are in ``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu import jit as jjit
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn.layer.layers import Parameter as JParameter
from paddle_tpu_torch import kernels
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.jit import AccumulateStep, TrainStep
from paddle_tpu_torch.kernels import optimizer as kopt
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     llama_state_from_numpy)

CFG = dict(ce_chunk=8)


def _loss(m, x, y):
    return m(x, labels=y)


def _llama_pair(seed=3):
    paddle.seed(seed)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(**CFG))
    rng = np.random.default_rng(seed)
    state = {}
    for name, v in jm.state_dict().items():
        a = (1.0 if "norm" in name else 0.0) + \
            0.1 * rng.standard_normal(tuple(v.shape))
        state[name] = a.astype(np.float32)
    jm.set_state_dict(state)
    pcfg = LlamaConfig.tiny(**CFG)
    pm = LlamaForCausalLM(pcfg, device="cpu")
    pm.load_state_dict(llama_state_from_numpy(state, pcfg))
    return jm, pm, pcfg


def _batch(rows, seed=4, cols=12):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(rows, cols)).astype(np.int32),
            rng.integers(0, 256, size=(rows, cols)).astype(np.int64))


def _port_state_of(jm, pcfg):
    """The JAX model's parameters in the port's layout (numpy)."""
    state = {k: np.asarray(v.numpy() if hasattr(v, "numpy") else v)
             for k, v in jm.state_dict().items()}
    return {k: v.numpy() for k, v in
            llama_state_from_numpy(state, pcfg).items()}


@pytest.fixture
def jax_flags():
    """The JAX package's eager embedding needs the 'clip' OOV policy under
    this jax; restored afterwards."""
    from paddle_tpu.framework import flags as flags_mod

    names = ["FLAGS_embedding_oov_policy"]
    prior = flags_mod.get_flags(names)
    paddle.set_flags({"FLAGS_embedding_oov_policy": "clip"})
    yield
    paddle.set_flags(prior)


def _adamw(mod, nn_mod, params, lr):
    return mod.AdamW(learning_rate=lr, parameters=params, weight_decay=0.01,
                     grad_clip=nn_mod.ClipGradByGlobalNorm(1.0))


# -- TrainStep ------------------------------------------------------------------

def test_trainstep_with_a_kept_table_matches_jax(jax_flags, monkeypatch):
    """Four steps under ``LinearWarmup`` (a new rate every step) of the
    port's ``TrainStep`` whose optimizer keeps one step table and rewrites
    only its header (the gradients are zeroed in place, so every step's
    tensors keep their storage) against the JAX ``jit.TrainStep``: each
    loss within 1e-4."""
    jm, pm, _ = _llama_pair()
    ids, labels = _batch(3)

    def sched(mod):
        return mod.lr.LinearWarmup(learning_rate=1e-2, warmup_steps=3,
                                   start_lr=1e-3, end_lr=1e-2)

    js, ps = sched(jopt), sched(popt)
    jstep = jjit.TrainStep(jm, _loss, _adamw(jopt, jnn, jm.parameters(), js))
    po = _adamw(popt, pnn, pm.parameters(), ps)
    pstep = TrainStep(pm, _loss, po)
    built = []
    real = kopt.StepBatch

    class Counted(real):
        def __init__(self, *a, **k):
            built.append(1)
            super().__init__(*a, **k)

    monkeypatch.setattr(kopt, "StepBatch", Counted)
    monkeypatch.setattr(po, "clear_grad",
                        lambda: popt.Optimizer.clear_grad(po, True))
    ref, got, lrs = [], [], []
    for _ in range(4):
        ref.append(float(jstep(paddle.to_tensor(ids),
                               paddle.to_tensor(labels))))
        js.step()
        lrs.append(po.get_lr())
        got.append(float(pstep(torch.from_numpy(ids),
                               torch.from_numpy(labels))))
        ps.step()
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert len(set(lrs)) == 4 and len(built) == 1
    assert po._batch.step == 4 and po._global_step == 4


def test_a_kept_table_with_new_words_equals_a_fresh_one():
    """A step table whose rate and step are rewritten (``set_step``) holds
    the same words, bit for bit, as a table built fresh for that rate and
    step: the header alone differs between steps."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(5, 3), (7,), (2, 3, 4)]
    params = [torch.randn(s, generator=gen) for s in shapes]
    grads = [torch.randn(s, generator=gen) for s in shapes]
    slots = [[torch.zeros_like(p) for p in params],
             [torch.zeros_like(p) for p in params], [None] * 3]

    def batch(lr, step):
        return kopt.StepBatch(params, grads, slots, [True, False, True], lr,
                              step, rule="adam")

    kept = batch(1e-3, 1)
    first = kept.host_table().copy()
    for lr, step in [(2.5e-4, 2), (3e-2, 7), (1e-3, 1000)]:
        kept.set_step(lr, step)
        fresh = batch(lr, step)._plan()
        np.testing.assert_array_equal(kept.host_table(), fresh)
        hw = kopt.HEADER_WORDS
        np.testing.assert_array_equal(kept.host_table()[hw:], first[hw:])
        head = fresh[:2].view(np.int32)
        assert head[0] == np.array([lr], np.float32).view(np.int32)[0]
        assert head[1] == step


def test_graph_on_the_cpu_runs_eagerly(jax_flags):
    """``graph=True`` (the default) on a CPU model runs the eager step:
    the same losses, bit for bit, as ``graph=False``, and no capture."""
    ids, labels = _batch(3)
    out = []
    for graph in (True, False):
        _, pm, _ = _llama_pair()
        step = TrainStep(pm, _loss, _adamw(popt, pnn, pm.parameters(), 1e-2),
                         graph=graph)
        out.append([float(step(torch.from_numpy(ids),
                               torch.from_numpy(labels))) for _ in range(3)])
        assert step.captures == 0 and step.replays == 0
    assert out[0] == out[1]


def test_a_step_neither_on_cuda_nor_the_cpu_raises(monkeypatch):
    """A model on another device (here ``meta``) raises rather than run; a
    CUDA model without a card cannot be made (the port's default device is
    CUDA, and it raises)."""
    cfg = LlamaConfig.tiny(**CFG)
    with torch.device("meta"):
        model = torch.nn.Linear(4, 4)
    step = TrainStep(model, lambda m, x: m(x).sum(),
                     popt.AdamW(parameters=model.parameters()))
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        step(torch.ones(2, 4, device="meta"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaForCausalLM(cfg)


# -- TrainStep.accumulate ----------------------------------------------------------

# the accumulation windows' gradients (batch 4, seed 6) have a global norm
# of 8.05 averaged and 8.05 k summed: the clip at 12 acts on the sums of 2
# and 4 microbatches and leaves the means as they are
ACC_CLIP = 12.0


def _acc_opt(mod, nn_mod, params):
    """AdamW with epsilon 1: the update is then about lr * m_hat, linear
    in the gradient (|g| ~ 0.015 here), so the parameters show the sums and
    their 1/k scale, which a normalised Adam step would hide."""
    return mod.AdamW(learning_rate=1e-2, parameters=params, epsilon=1.0,
                     weight_decay=0.01,
                     grad_clip=nn_mod.ClipGradByGlobalNorm(ACC_CLIP))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_accumulate_matches_jax(jax_flags, k, average, remat, monkeypatch):
    """Two steps of ``TrainStep.accumulate(k)`` on a batch of 4 rows
    against the JAX ``TrainStep.accumulate(k)`` (AdamW and a global-norm
    clip that the fp32 sums of 2 and 4 microbatches exceed): each loss
    (the mean of the microbatch losses) within 1e-4, every parameter
    within rtol 1e-5 of its value plus rtol of its tensor's largest element
    (an element near zero is a sum that cancels); one clip and one update
    a window."""
    jm, pm, pcfg = _llama_pair()
    ids, labels = _batch(4, seed=6)
    jacc = jjit.TrainStep(jm, _loss, _acc_opt(jopt, jnn, jm.parameters())) \
        .accumulate(k, remat=remat, average=average)
    pacc = TrainStep(pm, _loss, _acc_opt(popt, pnn, pm.parameters())) \
        .accumulate(k, remat=remat, average=average)
    assert isinstance(pacc, AccumulateStep)
    norms = []
    real = kopt.multi_tensor_sumsq

    def spy(*a, **kw):
        out = real(*a, **kw)
        norms.append(float(out[-1]) ** 0.5)
        return out

    monkeypatch.setattr(kopt, "multi_tensor_sumsq", spy)
    kernels.reset_counters()
    ref = [float(jacc(paddle.to_tensor(ids), paddle.to_tensor(labels)))
           for _ in range(2)]
    got = [float(pacc(torch.from_numpy(ids), torch.from_numpy(labels)))
           for _ in range(2)]
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    want = _port_state_of(jm, pcfg)
    for name, p in pm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[name]).max(),
                                   err_msg=name)
    assert (norms[0] > ACC_CLIP) == (k > 1 and not average), norms
    c = kernels.counters()
    assert c["multi_tensor_sumsq"]["plain_calls"] == 2
    assert c["adam_update"]["plain_calls"] == 2
    assert pacc.optimizer._global_step == 2


def test_accumulate_rejects_a_batch_that_does_not_divide():
    _, pm, _ = _llama_pair()
    acc = TrainStep(pm, _loss, popt.AdamW(parameters=pm.parameters())) \
        .accumulate(4)
    ids, labels = _batch(6)
    with pytest.raises(ValueError, match=r"accumulate\(4\): batch dim "
                                         r"\(6, 12\) must divide"):
        acc(torch.from_numpy(ids), torch.from_numpy(labels))
    with pytest.raises(ValueError, match="steps must be >= 1"):
        TrainStep(pm, _loss, popt.AdamW(parameters=pm.parameters())) \
            .accumulate(0)


# -- fp32 gradients beside bf16 parameters ------------------------------------------

SHAPES = {"w": (6, 40), "stack": (2, 5, 16), "norm.b": (24,), "one": (1,)}


def _bf16_ulps(a, b, base):
    """|a - b| in bf16 ulps of max(|a|, |b|, |base|), elementwise."""
    m = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.abs(base))
    m = np.maximum(m, 2.0 ** -126)
    return np.abs(a - b) / np.exp2(np.floor(np.log2(m)) - 7)


@pytest.mark.parametrize("rule", ["adamw", "adafactor", "adafactor_m"])
def test_fp32_gradients_beside_bf16_parameters_match_jax(rule):
    """The plain versions fed fp32 gradients for bf16 parameters (the sums
    of ``TrainStep.accumulate``) against the JAX package's updater fed the
    same fp32 gradients (``ClipGradByGlobalNorm(1.0)`` on the fp32 values,
    then the cast to bf16, then the rule), three steps: every bf16 value
    within one ulp (of the larger of the two and the value before the
    step) and 99% of them equal bit for bit; fp32 state within rtol 1e-5
    (and of its largest element)."""
    rng = np.random.default_rng(9)
    p0 = {n: (rng.choice([-1.0, 1.0], size=s) * rng.uniform(0.5, 1.5, size=s)
              * 0.05).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()} for _ in range(3)]
    if rule == "adamw":
        kw = dict(learning_rate=1e-3, weight_decay=0.1,
                  apply_decay_param_fun=lambda n: "norm" not in n)
        jcls, pcls = jopt.AdamW, popt.AdamW
    else:
        kw = dict(learning_rate=1e-2, beta1=0.5 if rule == "adafactor_m"
                  else 0.0)
        jcls, pcls = jopt.Adafactor, popt.Adafactor
    jps = [JParameter(jnp.asarray(p0[n]).astype(jnp.bfloat16), name=n)
           for n in SHAPES]
    jo = jcls(parameters=jps, grad_clip=jnn.ClipGradByGlobalNorm(1.0), **kw)
    update = jjit.make_param_updater(jo, jps)
    jstates = [jo._init_state(p.data) for p in jps]
    jparams = [p.data for p in jps]
    pps = {n: torch.nn.Parameter(torch.from_numpy(p0[n]).bfloat16())
           for n in SHAPES}
    po = pcls(parameters=list(pps.items()),
              grad_clip=pnn.ClipGradByGlobalNorm(1.0), **kw)
    kernels.reset_counters()
    for t, g in enumerate(grads, 1):
        before = {n: p.detach().float().numpy().copy()
                  for n, p in pps.items()}
        jg = jo._grad_clip._apply_jax([jnp.asarray(g[n]) for n in SHAPES])
        assert all(x.dtype == jnp.float32 for x in jg)
        jparams, jstates = update(jparams, jg, jstates,
                                  jnp.asarray(po.get_lr(), jnp.float32),
                                  jnp.asarray(t, jnp.int32))
        batch = po._apply([torch.from_numpy(g[n]) for n in SHAPES])
        assert batch.grads is None and all(
            p.dtype == torch.bfloat16 for p in batch.params)
        po._global_step += 1
        pairs = [(n, pps[n].detach(), jparams[i], before[n])
                 for i, n in enumerate(SHAPES)]
        for i, n in enumerate(SHAPES):
            for key, ref in jstates[i].items():
                got = po._state[id(pps[n])][key]
                pairs.append((f"{n}.{key}", got, ref, None))
        same = total = 0
        for what, got, ref, base in pairs:
            a = got.float().numpy()
            b = np.asarray(jnp.asarray(ref).astype(jnp.float32))
            if got.dtype == torch.bfloat16:
                base = a if base is None else base
                assert _bf16_ulps(a, b, base).max() <= 1, f"step {t} {what}"
                same += int((a == b).sum())
                total += a.size
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5,
                                           atol=1e-5 * np.abs(b).max(),
                                           err_msg=f"step {t} {what}")
        assert same >= 0.99 * total, (t, same, total)
    c = kernels.counters()
    assert c["multi_tensor_sumsq"]["plain_calls"] == 3
