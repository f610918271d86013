"""The port's DiT against the JAX package's.

Two sizes: ``DiTConfig.tiny()`` (hidden 64, 4 heads, head dim 16) and a
depth-2 model at hidden 288 with 4 heads, so head dim 72, the head dim of
DiT-XL/2 (1152 / 16), which takes the same attention route as XL/2. The
weights are drawn with numpy from a seed, every parameter non-zero (the
adaLN-Zero ``ada``, ``final_ada`` and ``final_proj`` start at zero, and a
fresh DiT outputs exactly zero), set into the JAX model and carried across
by ``dit_state_from_numpy`` into the port's (on the CPU, where attention is
the flash kernels' plain version; the JAX package's SDPA runs its XLA
composition). The JAX model runs with ``FLAGS_embedding_oov_policy`` at
'clip' (its eager 'error' path calls a removed jax API).

fp32 is held to 1e-5 relative: outputs elementwise to 1e-5 |ref| + 1e-5
(values of order 1), and a gradient, a sum over the batch and tokens whose
terms may cancel, to 1e-5 |ref| + 1e-5 max |ref| over its tensor. Under
``dtype="bfloat16"`` the parameters are bf16 in both packages but every
activation is fp32 (the timestep embedding and the inputs are fp32 and
the products promote), so the forward keeps the fp32 tolerance, and a bf16
weight's gradient, rounded once to bf16 from fp32 sums that differ in
order, may land one bf16 ulp away (2^-7 of its value at most) on top.

The draws (t, noise, the label drops, x_T and the eta noise) are the JAX
package's own, put in through ``paddle_tpu_torch.models.dit.draw``.

The timestep embedding is held on its own: its fp32 ``exp`` differs from
XLA's in the last bit of some frequencies, which cos(t f) turns into
errors of order 1e-7 |t f| (6e-5 at t = 999), and the model tests would
then measure that conditioning rather than the port. So the model-level
tests give the port's ``TimestepEmbedder`` the JAX package's embedding of
the same t (``same_timestep_embedding``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.optimizer as jopt
from paddle_tpu import jit as jjit
from paddle_tpu.framework import random as jrandom
from paddle_tpu.models import dit as jdit
import paddle_tpu_torch as P
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (DiT, DiTBlock, DiTConfig,
                                     GaussianDiffusion, LabelEmbedder,
                                     dit_param_count, dit_state_from_numpy)
from paddle_tpu_torch.models import dit as pdit

RTOL, ATOL = 1e-5, 1e-5
BF16_GRAD_RTOL = 2.0 ** -7
_MP = ("qkv", "proj", "fc1", "fc2")
SIZES = {"tiny": dict(), "d72": dict(hidden_size=288, num_attention_heads=4)}


@pytest.fixture(autouse=True)
def cpu_place():
    prior = P.get_device()
    P.set_device("cpu")
    yield
    P.set_device(prior)


@pytest.fixture(autouse=True)
def clip_embedding():
    """Eager ``F.embedding`` of the JAX package crashes under jax 0.9 with
    the default 'error' OOV policy; 'clip' takes the path that works."""
    from paddle_tpu.framework import flags as flags_mod

    prior = flags_mod.get_flags(["FLAGS_embedding_oov_policy"])
    J.set_flags({"FLAGS_embedding_oov_policy": "clip"})
    yield
    J.set_flags(prior)


@pytest.fixture
def same_timestep_embedding(monkeypatch):
    """The port's ``_timestep_embed`` answers with the JAX package's values
    for the same t (on the t's device), computed by the JAX primitive."""
    def jax_embed(t, dim, max_period=10000):
        ref = jdit._timestep_embed(J.to_tensor(t.cpu().numpy()), dim=dim,
                                   max_period=max_period)
        return torch.from_numpy(np.asarray(ref.numpy()).copy()).to(t.device)

    monkeypatch.setattr(pdit, "_timestep_embed", jax_embed)


def _is_mp_weight(name):
    parts = name.split(".")
    return len(parts) >= 2 and parts[-1] == "weight" and parts[-2] in _MP


def _port_layout(name, a):
    return a.T if _is_mp_weight(name) else a


def _weights(jm, seed):
    """Seeded numpy weights for every entry of ``jm``'s state: matrices
    ~ N(0, 1/fan_in) (JAX layout [in, out]), biases and vectors 0.1 N(0, 1),
    the label table N(0, 1); nothing zero."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, v in jm.state_dict().items():
        shape = tuple(v.shape)
        if name.endswith("table.weight"):
            a = rng.standard_normal(shape)
        elif len(shape) == 2:
            a = rng.standard_normal(shape) / np.sqrt(shape[0])
        else:
            a = 0.1 * rng.standard_normal(shape)
        state[name] = a.astype(np.float32)
    return state


def make_pair(size="d72", dtype="float32", seed=0, **kw):
    cfg = dict(SIZES[size], dtype=dtype, **kw)
    J.seed(seed)
    jm = jdit.DiT(jdit.DiTConfig.tiny(**cfg))
    state = _weights(jm, seed)
    jm.set_state_dict(state)
    pm = DiT(DiTConfig.tiny(**cfg))
    missing, unexpected = pm.set_state_dict(dit_state_from_numpy(state))
    assert not missing and not unexpected
    return jm, pm


def _inputs(cfg, b=3, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cfg.in_channels, cfg.input_size,
                             cfg.input_size)).astype(np.float32)
    t = rng.integers(0, 1000, (b,)).astype(np.int32)
    y = rng.integers(0, cfg.num_classes, (b,)).astype(np.int64)
    return x, t, y


def _close(got, ref, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


class _JaxDraws:
    """Stands in for ``paddle_tpu_torch.models.dit.draw``: hands out the
    given arrays in order, each checked against the kind and shape asked."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, kind, shape, generator, device, high=None):
        want_kind, arr = self.draws.pop(0)
        assert kind == want_kind and tuple(shape) == arr.shape, (kind, shape)
        return torch.from_numpy(np.asarray(arr).copy()).to(device)


def test_param_count_and_names():
    jm, pm = make_pair("d72")
    jsd, psd = jm.state_dict(), pm.state_dict()
    assert sorted(jsd) == sorted(psd)
    for k, v in jsd.items():
        assert _port_layout(k, np.zeros(tuple(v.shape))).shape == \
            tuple(psd[k].shape), k
    assert "pos_embed" not in psd  # not persistable, as in JAX
    assert sum(p.numel() for p in pm.parameters()) == \
        dit_param_count(pm.config)
    assert dit_param_count(DiTConfig.dit_xl_2()) == 674816272


def test_fresh_dit_outputs_zero_and_learn_sigma_raises():
    """adaLN-Zero: a fresh model predicts exactly zero, as the JAX one."""
    cfg = DiTConfig.tiny()
    m = DiT(cfg)
    x, t, y = _inputs(cfg)
    out = m(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y))
    assert out.shape == x.shape and float(out.detach().abs().max()) == 0.0
    with pytest.raises(NotImplementedError):
        DiT(DiTConfig.tiny(learn_sigma=True))


@pytest.mark.parametrize("dim", [256, 64])
def test_timestep_embed_and_sincos_table_match_jax(dim):
    """cos / sin of t f: torch's fp32 ``exp`` and XLA's differ in the last
    bit of some frequencies f, and a one-ulp change of f moves the argument
    t f by up to 1.2e-7 |t f|, so the embedding is held to 1e-6 |t f| +
    1e-5 (its values are within [-1, 1]; t up to 999)."""
    t = np.array([0, 1, 17, 500, 999], np.int32)
    ref = np.asarray(jdit._timestep_embed(J.to_tensor(t), dim=dim,
                                          max_period=10000).numpy())
    got = pdit._timestep_embed(torch.from_numpy(t), dim)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    half = dim // 2
    f = np.exp(-np.log(10000.0) * np.arange(half) / half)
    arg = np.abs(t[:, None] * np.concatenate([f, f])[None])
    assert (np.abs(got.numpy() - ref) <= 1e-6 * arg + 1e-5).all()
    for hidden, grid in ((64, 4), (1152, 16)):
        np.testing.assert_array_equal(
            pdit._sincos_pos_embed_2d(hidden, grid),
            np.asarray(jdit._sincos_pos_embed_2d(hidden, grid)))


@pytest.mark.parametrize("size", list(SIZES))
def test_patchify_round_trip_matches_jax(size):
    jm, pm = make_pair(size)
    x, _t, _y = _inputs(pm.config)
    ref = np.asarray(jm._patchify(J.to_tensor(x)).numpy())
    got = pm._patchify(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ref)
    tokens = np.random.default_rng(5).standard_normal(ref.shape).astype(
        np.float32)
    np.testing.assert_array_equal(
        pm._unpatchify(torch.from_numpy(tokens)).numpy(),
        np.asarray(jm._unpatchify(J.to_tensor(tokens)).numpy()))
    np.testing.assert_array_equal(pm._unpatchify(got).numpy(), x)


def _grads_match(jm, pm, bf16):
    jp = dict(jm.named_parameters())
    n = 0
    for name, p in pm.named_parameters():
        jg = _port_layout(name, np.asarray(jp[name].grad.numpy(), np.float32))
        assert p.grad is not None, name
        assert p.grad.dtype == p.dtype, name
        rtol = RTOL + (BF16_GRAD_RTOL if bf16 else 0.0)
        _close(p.grad.float().numpy(), jg, rtol=rtol,
               atol=RTOL * float(np.abs(jg).max()), msg=name)
        n += 1
    return n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", list(SIZES))
def test_block_forward_and_gradients_match_jax(size, dtype):
    jm, pm = make_pair(size, dtype)
    jb, pb = jm.blocks[0], pm.blocks[0]
    cfg = pm.config
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, pm.num_patches, cfg.hidden_size)).astype(
        np.float32)
    cond = rng.standard_normal((2, cfg.hidden_size)).astype(np.float32)
    jx, jc = J.to_tensor(x), J.to_tensor(cond)
    jx.stop_gradient = False
    ref = jb(jx, jc)
    px = torch.from_numpy(x).requires_grad_()
    got = pb(px, torch.from_numpy(cond))
    assert got.dtype == torch.float32
    _close(got.detach().numpy(), np.asarray(ref.numpy()))
    ref.sum().backward()
    got.sum().backward()
    _close(px.grad.numpy(), np.asarray(jx.grad.numpy()))
    assert _grads_match(jb, pb, dtype == "bfloat16") == 10


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", list(SIZES))
def test_dit_forward_and_gradients_match_jax(size, dtype, monkeypatch,
                                             same_timestep_embedding):
    """Eval forward and the gradients of sum(out^2), every parameter; under
    bf16 the attention sees fp32 q, k and v in both packages."""
    jm, pm = make_pair(size, dtype)
    jm.eval()
    pm.eval()
    x, t, y = _inputs(pm.config)
    seen = []
    real = PF.scaled_dot_product_attention

    def recording(q, k, v, *a, **kw):
        seen.append((q.dtype, k.dtype, v.dtype, q.shape[-1]))
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(PF, "scaled_dot_product_attention", recording)
    jseen = []
    jreal = jdit.F.scaled_dot_product_attention

    def jrecording(q, k, v, *a, **kw):
        jseen.append(str(q.dtype))
        return jreal(q, k, v, *a, **kw)

    monkeypatch.setattr(jdit.F, "scaled_dot_product_attention", jrecording)
    ref = jm(J.to_tensor(x), J.to_tensor(t), J.to_tensor(y))
    got = pm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    assert float(got.detach().abs().max()) > 0.1  # not the adaLN-Zero zeros
    _close(got.detach().numpy(), np.asarray(ref.numpy()))
    d = pm.config.hidden_size // pm.config.num_attention_heads
    assert seen == [(torch.float32,) * 3 + (d,)] * 2
    assert all(s == "float32" for s in jseen) and len(jseen) == 2
    (ref * ref).sum().backward()
    (got * got).sum().backward()
    assert _grads_match(jm, pm, dtype == "bfloat16") == \
        len(list(pm.parameters()))


def _jax_training_draws(seed, b, shape, T=1000, label_drop=True):
    """The draws the JAX ``training_loss`` makes after ``J.seed(seed)``:
    t, the noise, then (training, drop rate > 0) the label drops."""
    J.seed(seed)
    t = jax.random.randint(jrandom.next_key(), (b,), 0, T)
    noise = jax.random.normal(jrandom.next_key(), shape, jnp.float32)
    out = [("t", np.asarray(t).astype(np.int64)),
           ("noise", np.asarray(noise))]
    if label_drop:
        u = jax.random.uniform(jrandom.next_key(), (b,))
        out.append(("label_drop", np.asarray(u)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_loss_and_q_sample_match_jax(dtype, monkeypatch,
                                              same_timestep_embedding):
    """``q_sample`` and ``training_loss`` with explicit t and noise, then
    with the JAX package's own draws (t, noise, and the label drops at 0.5
    so that some labels become the null class)."""
    jm, pm = make_pair("d72", dtype, class_dropout_prob=0.5)
    jd, pd = jdit.GaussianDiffusion(), GaussianDiffusion()
    x, t, y = _inputs(pm.config, b=6)
    noise = np.random.default_rng(3).standard_normal(x.shape).astype(
        np.float32)
    ref = jd.q_sample(J.to_tensor(x), J.to_tensor(t), J.to_tensor(noise))
    got = pd.q_sample(torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(noise))
    _close(got.numpy(), np.asarray(ref.numpy()))
    jm.eval()
    pm.eval()
    ref = jd.training_loss(jm, J.to_tensor(x), J.to_tensor(y),
                           J.to_tensor(t), J.to_tensor(noise))
    got = pd.training_loss(pm, torch.from_numpy(x), torch.from_numpy(y),
                           torch.from_numpy(t), torch.from_numpy(noise))
    _close(float(got), float(ref))
    jm.train()
    pm.train()
    draws = _jax_training_draws(11, 6, x.shape)
    drops = draws[2][1] < 0.5
    assert 0 < drops.sum() < 6  # both branches of the drop
    J.seed(11)
    ref = jd.training_loss(jm, J.to_tensor(x), J.to_tensor(y))
    monkeypatch.setattr(pdit, "draw", _JaxDraws(draws))
    got = pd.training_loss(pm, torch.from_numpy(x), torch.from_numpy(y))
    _close(float(got), float(ref))


def test_label_embedder_drop_rate_and_null_row():
    """On the port's own generator: the drop share is within 4 sigma of p,
    a dropped label reads the null row, a kept one its own, eval drops
    none, and one seed gives one set of drops."""
    emb = LabelEmbedder(10, 8, 0.25, generator=torch.Generator())
    n = 20000
    labels = torch.arange(n) % 10
    emb.generator.manual_seed(3)
    out = emb(labels)
    null = emb.table.weight[10]
    dropped = (out == null).all(dim=1)
    share = float(dropped.float().mean())
    assert abs(share - 0.25) < 4 * (0.25 * 0.75 / n) ** 0.5
    torch.testing.assert_close(out[~dropped],
                               emb.table.weight[labels[~dropped]])
    emb.generator.manual_seed(3)
    assert torch.equal(emb(labels), out)
    emb.eval()
    torch.testing.assert_close(emb(labels), emb.table.weight[labels])


def _step_recipe(opt_mod, model, diffusion, lr):
    opt = opt_mod.AdamW(learning_rate=lr, parameters=model.parameters(),
                        weight_decay=0.0)
    return (lambda m, x, y, t, n: diffusion.training_loss(m, x, y, t, n)), \
        opt


ADAM_NOISE_SHARE = 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_adamw_steps_match_jax_train_step(dtype,
                                                same_timestep_embedding):
    """Three ``TrainStep`` steps (AdamW, weight decay 0 as ``bench.py``'s
    DiT row; lr 1e-3 so that three steps move the weights past the
    tolerance) with explicit t and noise per step and no label drop:
    losses and every parameter against the JAX ``jit.TrainStep``.

    Adam divides each gradient element by its own running RMS, so an
    element whose gradient is rounding noise (0.03% of one weight here sit
    below 1e-5 of their tensor's largest) moves by up to lr a step in
    either package, in directions the noise picks. The parameters are
    therefore held to the fp32 tolerance in all but ADAM_NOISE_SHARE of
    each tensor's elements, and every element within 2 lr a step of the
    JAX one. Under bf16 a parameter may round one bf16 ulp (2^-7 of it)
    apart after an update, which moves the later losses by ~1e-5 of
    themselves, so bf16 losses are held to 1e-4. The key third of each
    ``qkv.bias`` has a zero gradient in exact arithmetic (the softmax
    cancels q.b_k, ROADMAP's oracle caveats): all of it is noise, so it is
    held to the 2 lr a step alone, as the GPT and BERT tests hold theirs."""
    lr, steps = 1e-3, 3
    jm, pm = make_pair("d72", dtype, class_dropout_prob=0.0)
    jd, pd = jdit.GaussianDiffusion(), GaussianDiffusion()
    jfn, jo = _step_recipe(jopt, jm, jd, lr)
    pfn, po = _step_recipe(popt, pm, pd, lr)
    jstep, pstep = jjit.TrainStep(jm, jfn, jo), TrainStep(pm, pfn, po)
    ref, got = [], []
    for i in range(steps):
        x, t, y = _inputs(pm.config, b=4, seed=20 + i)
        n = np.random.default_rng(30 + i).standard_normal(x.shape).astype(
            np.float32)
        ref.append(float(jstep(*(J.to_tensor(a) for a in (x, y, t, n)))))
        got.append(float(pstep(*(torch.from_numpy(a) for a in (x, y, t, n)))))
    bf16 = dtype == "bfloat16"
    _close(got, ref, rtol=1e-4 if bf16 else RTOL)
    jsd = dict(jm.named_parameters())
    rtol = RTOL + (BF16_GRAD_RTOL if bf16 else 0.0)
    for name, p in pm.named_parameters():
        a = p.detach().float().numpy()
        b = _port_layout(name, np.asarray(jsd[name].numpy(), np.float32))
        off = np.abs(a - b) > rtol * np.abs(b) + ATOL
        if name.endswith("qkv.bias"):
            h = a.shape[0] // 3
            off[h:2 * h] = False
        assert off.mean() <= ADAM_NOISE_SHARE, (name, off.mean())
        assert np.abs(a - b).max() <= 2 * lr * steps + rtol * np.abs(b).max(), \
            (name, np.abs(a - b).max())


def _jax_ddim_draws(seed, shape, steps, eta):
    """The x_T and eta draws of the JAX ``ddim_sample`` (``jax.random.key
    (seed)`` split once for x_T and once a step with sigma > 0)."""
    jd = jdit.GaussianDiffusion()
    key = jax.random.key(seed)
    key, sub = jax.random.split(key)
    out = [("x_T", np.asarray(jax.random.normal(sub, shape, jnp.float32)))]
    ts = np.linspace(jd.T - 1, 0, steps).astype(np.int64)
    for i in range(len(ts) - 1):
        ab_t = float(jd._alphas_bar_np[int(ts[i])])
        ab_prev = float(jd._alphas_bar_np[int(ts[i + 1])])
        sigma = eta * np.sqrt((1 - ab_prev) / (1 - ab_t)) * \
            np.sqrt(1 - ab_t / ab_prev)
        if sigma > 0:
            key, sub = jax.random.split(key)
            out.append(("eta", np.asarray(jax.random.normal(
                sub, shape, jnp.float32))))
    return out


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_matches_jax(eta, monkeypatch, same_timestep_embedding):
    jm, pm = make_pair("d72")
    cfg = pm.config
    shape = (2, cfg.in_channels, cfg.input_size, cfg.input_size)
    y = np.array([1, 7], np.int64)
    steps = 6
    ref = jdit.GaussianDiffusion().ddim_sample(jm, shape, J.to_tensor(y),
                                               steps=steps, eta=eta, seed=4)
    draws = _jax_ddim_draws(4, shape, steps, eta)
    assert len(draws) == (1 if eta == 0.0 else steps)
    monkeypatch.setattr(pdit, "draw", _JaxDraws(draws))
    pm.train()
    got = GaussianDiffusion().ddim_sample(pm, shape, torch.from_numpy(y),
                                          steps=steps, eta=eta, seed=4)
    assert pm.training  # put back
    _close(got.numpy(), np.asarray(ref.numpy()), rtol=1e-4, atol=1e-4)


def test_ddim_sample_is_deterministic_on_its_seed():
    _jm, pm = make_pair("tiny")
    d = GaussianDiffusion()
    y = torch.tensor([1, 2])
    shape = (2, 3, 8, 8)
    a = d.ddim_sample(pm, shape, y, steps=4, eta=0.5, seed=1)
    b = d.ddim_sample(pm, shape, y, steps=4, eta=0.5, seed=1)
    c = d.ddim_sample(pm, shape, y, steps=4, eta=0.5, seed=2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()


def test_block_is_identity_when_ada_is_zero():
    cfg = DiTConfig.tiny(hidden_size=288, num_attention_heads=4)
    blk = DiTBlock(cfg)
    x = torch.randn(2, 16, 288)
    torch.testing.assert_close(blk(x, torch.randn(2, 288)), x)
