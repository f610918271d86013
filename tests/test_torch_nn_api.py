"""The port's ``nn`` surface against the JAX package's.

For each layer the JAX layer is built, its ``state_dict()`` copied as numpy
into the port's layer through ``set_state_dict`` (names and shapes must be
equal), and the forward and the gradients of ``sum(out * w)`` with
respect to the floating inputs and every parameter are compared, within
1e-5 (fp32). The initializers are checked by their statistics on [512,
512] against the JAX initializers' and their fans against the JAX
``_fans``. Inputs are made by numpy from a seed; the port runs on the CPU
(``set_device("cpu")``).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
import paddle_tpu_torch as P
import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.nn.functional as pF
from paddle_tpu_torch.nn import initializer as pI

TOL = 1e-5


@pytest.fixture(autouse=True)
def cpu_place():
    prior = P.get_device()
    P.set_device("cpu")
    yield
    P.set_device(prior)


@pytest.fixture
def clip_embedding():
    """Eager ``F.embedding`` of the JAX package crashes under jax 0.9 with
    the default 'error' OOV policy (it calls a removed jax API); 'clip'
    takes the path that works. Restored afterwards."""
    from paddle_tpu.framework import flags as flags_mod

    prior = flags_mod.get_flags(["FLAGS_embedding_oov_policy"])
    J.set_flags({"FLAGS_embedding_oov_policy": "clip"})
    yield
    J.set_flags(prior)


def f(*shape, lo=-2.0, hi=2.0, seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def labels(*shape, n=5, seed=1):
    return np.random.default_rng(seed).integers(0, n, shape).astype(np.int64)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.numpy())


def _copy_state(jl, pl):
    jsd = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    psd = pl.state_dict()
    assert sorted(jsd) == sorted(psd)
    for k in jsd:
        assert tuple(jsd[k].shape) == tuple(psd[k].shape), k
    missing, unexpected = pl.set_state_dict(jsd)
    assert not missing and not unexpected


def compare_layer(jl, pl, inputs, diff=None, seed=7):
    """Forward and gradients of the JAX layer ``jl`` and the port's ``pl``
    on ``inputs`` (numpy arrays; ``diff[i]``: take input i's gradient)."""
    _copy_state(jl, pl)
    diff = diff or [a.dtype.kind == "f" for a in inputs]
    jin = [J.to_tensor(a, stop_gradient=not d) for a, d in zip(inputs, diff)]
    pin = [torch.tensor(a, requires_grad=bool(d)) for a, d in
           zip(inputs, diff)]
    jout, pout = jl(*jin), pl(*pin)
    assert list(pout.shape) == list(jout.shape)
    np.testing.assert_allclose(_np(pout), _np(jout), rtol=TOL, atol=TOL)
    if not pout.requires_grad:
        return
    w = np.random.default_rng(seed).standard_normal(
        tuple(pout.shape)).astype(np.float32)
    J.sum(J.multiply(jout, J.to_tensor(w))).backward()
    (pout * torch.tensor(w)).sum().backward()
    for ja, pa, d in zip(jin, pin, diff):
        if d:
            np.testing.assert_allclose(_np(pa.grad), _np(ja.grad), rtol=TOL,
                                       atol=TOL)
    jp = dict(jl.named_parameters())
    for name, p in pl.named_parameters():
        jg = jp[name].grad
        jg = np.zeros(tuple(p.shape), np.float32) if jg is None else _np(jg)
        pg = np.zeros(tuple(p.shape), np.float32) if p.grad is None else \
            _np(p.grad)
        np.testing.assert_allclose(pg, jg, rtol=TOL, atol=TOL, err_msg=name)


# (id, layer class name, constructor args, constructor kwargs, inputs)
LAYERS = [
    ("linear", "Linear", (4, 3), {}, lambda: [f(2, 5, 4)]),
    ("linear-no-bias", "Linear", (4, 3), dict(bias_attr=False),
     lambda: [f(5, 4)]),
    ("flatten", "Flatten", (), {}, lambda: [f(2, 3, 4)]),
    ("identity", "Identity", (), {}, lambda: [f(2, 3)]),
    ("cosine-similarity", "CosineSimilarity", (), dict(axis=1),
     lambda: [f(3, 4), f(3, 4, seed=1)]),
    ("bilinear", "Bilinear", (3, 4, 2), {}, lambda: [f(5, 3),
                                                     f(5, 4, seed=1)]),
    ("layer-norm", "LayerNorm", (4,), {}, lambda: [f(2, 3, 4)]),
    ("layer-norm-2d", "LayerNorm", ([3, 4],), dict(epsilon=1e-6),
     lambda: [f(2, 3, 4)]),
    ("dropout-eval-identity", "Dropout", (0.0,), {}, lambda: [f(3, 4)]),
]
_ACT_ARGS = {"LeakyReLU": (0.2,), "ELU": (0.7,), "CELU": (1.3,),
             "Hardtanh": (-0.5, 0.8), "Hardshrink": (0.3,),
             "Softshrink": (0.3,), "ThresholdedReLU": (0.4,),
             "Softmax": (0,), "LogSoftmax": (1,), "Maxout": (2,),
             "GELU": (True,), "SELU": ()}
for _a in ["ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Silu", "Swish",
           "Mish", "Hardswish", "Hardsigmoid", "Softsign", "Tanhshrink",
           "LogSigmoid", "LeakyReLU", "ELU", "SELU", "CELU", "Hardtanh",
           "Hardshrink", "Softshrink", "Softplus", "ThresholdedReLU",
           "Softmax", "LogSoftmax", "Maxout"]:
    LAYERS.append((_a.lower(), _a, _ACT_ARGS.get(_a, ()), {},
                   lambda: [f(2, 4, 3, lo=-4, hi=4, seed=4)]))
LAYERS += [
    ("gelu-erf", "GELU", (), {}, lambda: [f(3, 5, lo=-4, hi=4)]),
    ("prelu", "PReLU", (), {}, lambda: [f(2, 3, 4)]),
    ("prelu-channels", "PReLU", (3,), dict(init=0.1), lambda: [f(2, 3, 4)]),
]


@pytest.mark.parametrize("cls,args,kwargs,make",
                         [pytest.param(*c[1:], id=c[0]) for c in LAYERS])
def test_layer_matches_jax(cls, args, kwargs, make):
    compare_layer(getattr(jnn, cls)(*args, **kwargs),
                  getattr(pnn, cls)(*args, **kwargs), make())


def test_embedding_matches_jax_with_padding_idx(clip_embedding):
    ids = np.array([[1, 2, 0], [2, 9, 4]])
    jl, pl = jnn.Embedding(10, 4, padding_idx=2), pnn.Embedding(
        10, 4, padding_idx=2)
    compare_layer(jl, pl, [ids], diff=[False])
    assert float(pl(torch.tensor(ids)).detach()[0, 1].abs().max()) == 0.0
    assert float(pl.weight.grad[2].abs().max()) == 0.0


def test_embedding_oov_policy(monkeypatch):
    """'error' raises on an eager lookup past the table, 'clip' (per call
    or by the flag) clamps, and under a CUDA graph capture (simulated:
    nothing can be read back there) 'error' clamps too."""
    from paddle_tpu_torch.nn.functional import common as Fc

    pl = pnn.Embedding(5, 3)
    bad = torch.tensor([0, 5])
    with pytest.raises(ValueError, match="out of range"):
        pl(bad)
    with pytest.raises(ValueError, match="out of range"):
        pl(torch.tensor([-1, 2]))
    clamped = pF.embedding(bad, pl.weight, oov_policy="clip")
    assert torch.equal(clamped[1], pl.weight[4])
    prior = P.get_flags("FLAGS_embedding_oov_policy")
    P.set_flags({"FLAGS_embedding_oov_policy": "clip"})
    try:
        assert torch.equal(pl(bad), clamped)
    finally:
        P.set_flags(prior)
    monkeypatch.setattr(Fc, "_capturing_on", lambda t: True)
    assert torch.equal(pl(bad), clamped)


# (id, loss class, constructor kwargs, inputs)
LOSSES = [
    ("ce", "CrossEntropyLoss", {}, lambda: [f(6, 5), labels(6)]),
    ("ce-labels-n1", "CrossEntropyLoss", {}, lambda: [f(6, 5),
                                                      labels(6, 1)]),
    ("ce-ignore", "CrossEntropyLoss", dict(ignore_index=1),
     lambda: [f(6, 5), labels(6)]),
    ("ce-ignore-100", "CrossEntropyLoss", {},
     lambda: [f(6, 5), np.array([0, -100, 2, -100, 4, 1])]),
    ("ce-sum", "CrossEntropyLoss", dict(reduction="sum"),
     lambda: [f(6, 5), labels(6)]),
    ("ce-none", "CrossEntropyLoss", dict(reduction="none"),
     lambda: [f(6, 5), labels(6)]),
    ("ce-soft", "CrossEntropyLoss", dict(soft_label=True),
     lambda: [f(6, 5), f(6, 5, lo=0, hi=1, seed=3)]),
    ("ce-axis", "CrossEntropyLoss", dict(axis=1),
     lambda: [f(2, 5, 3), labels(2, 3)]),
    ("ce-probs", "CrossEntropyLoss", dict(use_softmax=False),
     lambda: [f(6, 5, lo=0.05, hi=1), labels(6)]),
    ("mse", "MSELoss", {}, lambda: [f(3, 4), f(3, 4, seed=1)]),
    ("mse-sum", "MSELoss", dict(reduction="sum"),
     lambda: [f(3, 4), f(3, 4, seed=1)]),
    ("l1", "L1Loss", {}, lambda: [f(3, 4), f(3, 4, seed=1)]),
    ("nll", "NLLLoss", {}, lambda: [f(6, 5, hi=0), labels(6)]),
    ("nll-4d", "NLLLoss", dict(reduction="none"),
     lambda: [f(2, 5, 3, hi=0), labels(2, 3)]),
    ("bce", "BCELoss", {}, lambda: [f(3, 4, lo=0.05, hi=0.95),
                                    f(3, 4, lo=0, hi=1, seed=1)]),
    ("bce-logits", "BCEWithLogitsLoss", {},
     lambda: [f(3, 4), f(3, 4, lo=0, hi=1, seed=1)]),
    ("kldiv", "KLDivLoss", dict(reduction="batchmean"),
     lambda: [f(3, 4, hi=0), f(3, 4, lo=0.01, hi=1, seed=1)]),
    ("smooth-l1", "SmoothL1Loss", dict(delta=0.5),
     lambda: [f(3, 4), f(3, 4, seed=1)]),
    ("margin-ranking", "MarginRankingLoss", dict(margin=0.1),
     lambda: [f(6), f(6, seed=1), np.sign(f(6, seed=2))]),
    ("hinge-embedding", "HingeEmbeddingLoss", {},
     lambda: [f(6), np.array([1, -1, 1, -1, -1, 1], np.float32)]),
    ("cosine-embedding", "CosineEmbeddingLoss", dict(margin=0.2),
     lambda: [f(4, 3), f(4, 3, seed=1), np.array([1, -1, 1, -1])]),
]


@pytest.mark.parametrize("cls,kwargs,make",
                         [pytest.param(*c[1:], id=c[0]) for c in LOSSES])
def test_loss_matches_jax(cls, kwargs, make):
    inputs = make()
    diff = [a.dtype.kind == "f" and i < (2 if cls in (
        "MarginRankingLoss", "CosineEmbeddingLoss") else 1)
        for i, a in enumerate(inputs)]
    compare_layer(getattr(jnn, cls)(**kwargs), getattr(pnn, cls)(**kwargs),
                  inputs, diff)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("soft", [False, True])
def test_weighted_cross_entropy_matches_jax(reduction, soft):
    w = f(5, lo=0.2, hi=2, seed=9)
    lab = f(6, 5, lo=0, hi=1, seed=3) if soft else \
        np.array([0, 1, -100, 3, 4, 1])
    x = f(6, 5)
    jx, px = J.to_tensor(x, stop_gradient=False), torch.tensor(
        x, requires_grad=True)
    jo = jF.cross_entropy(jx, J.to_tensor(lab), weight=J.to_tensor(w),
                          reduction=reduction, soft_label=soft)
    po = pF.cross_entropy(px, torch.tensor(lab), weight=torch.tensor(w),
                          reduction=reduction, soft_label=soft)
    np.testing.assert_allclose(_np(po), _np(jo), rtol=TOL, atol=TOL)
    J.sum(jo).backward()
    po.sum().backward()
    np.testing.assert_allclose(_np(px.grad), _np(jx.grad), rtol=TOL,
                               atol=TOL)


# (id, functional, args, kwargs)
FUNCTIONALS = [
    ("linear", "linear", lambda: [f(3, 4), f(4, 2, seed=1), f(2, seed=2)],
     {}),
    ("layer_norm-no-affine", "layer_norm", lambda: [f(2, 3, 4)],
     dict(normalized_shape=4)),
    ("normalize", "normalize", lambda: [f(3, 4)], dict(axis=1)),
    ("normalize-p1", "normalize", lambda: [f(3, 4)], dict(p=1, axis=0)),
    ("cosine_similarity", "cosine_similarity",
     lambda: [f(3, 4), f(3, 4, seed=1)], dict(axis=0)),
    ("bilinear", "bilinear",
     lambda: [f(5, 3), f(5, 4, seed=1), f(2, 3, 4, seed=2)], {}),
    ("pad", "pad", lambda: [f(1, 2, 3, 4)], dict(pad=[1, 2, 0, 1],
                                                 value=0.5)),
    ("softmax-dtype", "softmax", lambda: [f(3, 4)], dict(axis=0,
                                                         dtype="float64")),
    ("log_softmax", "log_softmax", lambda: [f(3, 4)], dict(axis=1)),
    ("glu", "glu", lambda: [f(3, 4)], dict(axis=-1)),
    ("gelu-tanh", "gelu", lambda: [f(3, 4)], dict(approximate=True)),
    ("tanh", "tanh", lambda: [f(3, 4)], {}),
    ("relu", "relu", lambda: [f(3, 4)], {}),
    ("square_error_cost", "square_error_cost",
     lambda: [f(3, 4), f(3, 4, seed=1)], {}),
    ("softmax_with_cross_entropy", "softmax_with_cross_entropy",
     lambda: [f(4, 5), labels(4, 1)], {}),
]


@pytest.mark.parametrize("name,make,kwargs",
                         [pytest.param(*c[1:], id=c[0]) for c in FUNCTIONALS])
def test_functional_matches_jax(name, make, kwargs):
    args = make()
    jin = [J.to_tensor(a, stop_gradient=a.dtype.kind != "f") for a in args]
    pin = [torch.tensor(a, requires_grad=a.dtype.kind == "f") for a in args]
    jo, po = getattr(jF, name)(*jin, **kwargs), getattr(pF, name)(*pin,
                                                                  **kwargs)
    np.testing.assert_allclose(_np(po), _np(jo), rtol=TOL, atol=TOL)
    w = np.random.default_rng(5).standard_normal(tuple(po.shape)).astype(
        np.float32)
    J.sum(J.multiply(jo, J.to_tensor(w))).backward()
    (po * torch.tensor(w, dtype=po.dtype)).sum().backward()
    for ja, pa in zip(jin, pin):
        if pa.requires_grad:
            np.testing.assert_allclose(_np(pa.grad), _np(ja.grad), rtol=TOL,
                                       atol=TOL)


def test_dropout_layer_draws_from_the_default_generator():
    d = pnn.Dropout(0.25)
    x = torch.ones(4000)
    P.seed(3)
    a = d(x)
    P.seed(3)
    assert torch.equal(a, d(x))
    kept = float((a != 0).float().mean())
    assert 0.7 < kept < 0.8
    assert set(a.unique().tolist()) == {0.0, float(np.float32(1.0 / 0.75))}
    d.eval()
    assert torch.equal(d(x), x)
    down = pnn.Dropout(0.25, mode="downscale_in_infer").eval()
    assert torch.allclose(down(x), x * 0.75)


# -- containers ----------------------------------------------------------------

def test_sequential_and_layer_list_match_jax():
    jl = jnn.Sequential(jnn.Linear(4, 6), jnn.GELU(), jnn.Linear(6, 2))
    pl = pnn.Sequential(pnn.Linear(4, 6), pnn.GELU(), pnn.Linear(6, 2))
    compare_layer(jl, pl, [f(3, 4)])
    assert sorted(pl.state_dict()) == ["0.bias", "0.weight", "2.bias",
                                       "2.weight"]
    named = pnn.Sequential(("fc", pnn.Linear(2, 2)), ("act", pnn.ReLU()))
    assert list(named.state_dict()) == ["fc.weight", "fc.bias"]
    assert isinstance(named[0], pnn.Linear) and len(named[:1]) == 1

    class Stack(jnn.Layer):
        def __init__(self, nn_mod):
            super().__init__()
            self.blocks = nn_mod.LayerList([nn_mod.Linear(4, 4)
                                            for _ in range(3)])

        def forward(self, x):
            for b in self.blocks:
                x = b(x)
            return x

    class PStack(pnn.Layer):
        forward = Stack.forward

        def __init__(self):
            pnn.Layer.__init__(self)
            self.blocks = pnn.LayerList([pnn.Linear(4, 4) for _ in range(3)])

    compare_layer(Stack(jnn), PStack(), [f(2, 4)])
    ll = pnn.LayerList([pnn.Linear(1, 1)])
    ll.append(pnn.ReLU()).extend([pnn.Tanh()])
    ll.insert(0, pnn.Identity())
    assert [type(m).__name__ for m in ll] == ["Identity", "Linear", "ReLU",
                                              "Tanh"]
    assert isinstance(ll[-1], pnn.Tanh) and len(ll[1:3]) == 2


def test_layer_dict_and_parameter_list():
    d = pnn.LayerDict({"a": pnn.Linear(2, 3)})
    d["b"] = pnn.ReLU()
    assert list(d.keys()) == ["a", "b"] and "a" in d and len(d) == 2
    assert sorted(d.state_dict()) == ["a.bias", "a.weight"]
    d.pop("b")
    assert list(d) == ["a"]
    owner = pnn.Layer()
    ps = pnn.ParameterList([owner.create_parameter([2, 2]),
                            owner.create_parameter([3], is_bias=True)])
    ps.append(owner.create_parameter([1]))
    assert len(ps) == 3 and sorted(ps.state_dict()) == ["0", "1", "2"]
    assert len(ps.parameters()) == 3


# -- Layer surface ------------------------------------------------------------

class _Net(pnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = pnn.Linear(4, 3)
        self.norm = pnn.LayerNorm(3)
        self.register_buffer("steps", torch.zeros(1))
        self.register_buffer("scratch", torch.zeros(2), persistable=False)

    def forward(self, x):
        return self.norm(self.fc(x))


def test_layer_surface():
    net = _Net()
    assert isinstance(net.parameters(), list) and len(net.parameters()) == 4
    assert [type(m).__name__ for m in net.sublayers()] == ["Linear",
                                                           "LayerNorm"]
    assert len(net.sublayers(include_self=True)) == 3
    assert sorted(net.state_dict()) == ["fc.bias", "fc.weight",
                                        "norm.bias", "norm.weight", "steps"]
    assert sorted(net.state_dict(include_sublayers=False)) == ["steps"]
    assert list(net.state_dict(structured_name_prefix="m.")
                )[0].startswith("m.")
    assert not net.eval().training and not net.fc.training
    assert net.train().fc.training
    state = {k: v.numpy() + 1.0 for k, v in net.state_dict().items()}
    state["extra"] = np.zeros(1)
    missing, unexpected = net.set_state_dict(state)
    assert missing == [] and unexpected == ["extra"]
    assert torch.equal(net.steps, torch.ones(1))
    with pytest.raises(ValueError, match="shape mismatch"):
        net.set_state_dict({"fc.weight": np.zeros((3, 4))})
    net.to(dtype="bfloat16")
    assert net.fc.weight.dtype == torch.bfloat16
    assert isinstance(net.fc.weight, pnn.Parameter)
    net.to("cpu", "float32")
    assert net.fc.weight.dtype == torch.float32 and \
        net.steps.dtype == torch.float32
    net.clear_gradients()
    assert all(p.grad is None for p in net.parameters())


def test_forward_hooks_match_jax():
    calls = []

    def pre(layer, inputs):
        calls.append("pre")
        return (inputs[0] * 2,)

    def post(layer, inputs, outputs):
        calls.append("post")
        return outputs + 1

    outs = []
    for nn_mod, mk in ((jnn, lambda a: J.to_tensor(a)),
                       (pnn, lambda a: torch.tensor(a))):
        layer = nn_mod.Identity()
        h1 = layer.register_forward_pre_hook(pre)
        h2 = layer.register_forward_post_hook(post)
        outs.append(_np(layer(mk(np.ones(2, np.float32)))))
        h1.remove()
        h2.remove()
        outs.append(_np(layer(mk(np.ones(2, np.float32)))))
    assert calls == ["pre", "post"] * 2
    np.testing.assert_array_equal(outs[0], outs[2])
    np.testing.assert_array_equal(outs[1], outs[3])
    assert outs[0].tolist() == [3.0, 3.0] and outs[1].tolist() == [1.0, 1.0]


def test_create_parameter_and_param_attr():
    layer = pnn.Layer()
    w = layer.create_parameter([64, 32])
    bound = math.sqrt(6.0 / (64 + 32))
    assert isinstance(w, pnn.Parameter) and w.requires_grad
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * \
        bound
    assert float(layer.create_parameter([8], is_bias=True).abs().max()) == 0
    attr = P.ParamAttr(name="w0", initializer=pI.Constant(0.5),
                       learning_rate=0.1, trainable=False, need_clip=False)
    p = layer.create_parameter([2, 2], attr=attr,
                               default_initializer=pI.Constant(9.0))
    assert float(p.max()) == 0.5 and p.stop_gradient and not p.trainable
    assert p.name == "w0" and p.optimize_attr["learning_rate"] == 0.1
    assert p.need_clip is False and p.is_distributed is False
    assert layer.create_parameter([2], attr=False) is None
    q = layer.create_parameter([3], attr=pI.Constant(2.0))
    assert float(q.min()) == 2.0
    q.stop_gradient = True
    assert not q.requires_grad
    lin = pnn.Linear(3, 2, weight_attr=P.ParamAttr(
        initializer=pI.Assign(np.arange(6).reshape(3, 2))),
        bias_attr=False)
    assert lin.bias is None and "bias" not in lin.state_dict()
    assert lin.weight.tolist() == [[0, 1], [2, 3], [4, 5]]


# -- initializers --------------------------------------------------------------

def _stats(name, args, shape=(512, 512)):
    from paddle_tpu.nn import initializer as jI

    P.seed(0)
    J.seed(0)
    p = getattr(pI, name)(*args)(list(shape)).numpy()
    j = np.asarray(getattr(jI, name)(*args)(list(shape), "float32"))
    return p, j


@pytest.mark.parametrize("name,args,mean,std,bound", [
    ("Constant", (0.3,), 0.3, 0.0, 0.3),
    ("Uniform", (-0.5, 1.5), 0.5, 2.0 / math.sqrt(12), 1.5),
    ("Normal", (0.2, 0.5), 0.2, 0.5, None),
    ("TruncatedNormal", (0.1, 0.5), 0.1, 0.5 * 0.87962566, 0.1 + 2 * 0.5),
    ("XavierUniform", (), 0.0, math.sqrt(6.0 / 1024) / math.sqrt(3),
     math.sqrt(6.0 / 1024)),
    ("XavierNormal", (), 0.0, math.sqrt(2.0 / 1024), None),
    ("KaimingUniform", (), 0.0, math.sqrt(6.0 / 512) / math.sqrt(3),
     math.sqrt(6.0 / 512)),
    ("KaimingNormal", (), 0.0, math.sqrt(2.0 / 512), None),
])
def test_initializer_statistics_match_jax(name, args, mean, std, bound):
    """Mean and std within 2% of the distribution's (of its std, for the
    mean), the same bounds, in both packages."""
    p, j = _stats(name, args)
    for a in (p, j):
        assert a.shape == (512, 512) and a.dtype == np.float32
        assert abs(a.mean() - mean) <= 0.02 * max(std, 1e-6) + 1e-7
        assert abs(a.std() - std) <= 0.02 * std + 1e-7
        if bound is not None:
            assert a.max() <= bound + 1e-6
            assert a.min() >= (2 * mean - bound) - 1e-6
    if name == "TruncatedNormal":  # cut at 2 std, and reaches near it
        assert p.max() > 0.1 + 2 * 0.5 * 0.99
        assert p.min() < 0.1 - 2 * 0.5 * 0.99


@pytest.mark.parametrize("shape", [(), (7,), (5, 3), (8, 4, 3, 3),
                                   (6, 2, 5)])
def test_fans_match_jax(shape):
    from paddle_tpu.nn.initializer import _fans as jfans
    from paddle_tpu_torch.nn.initializer import _fans as pfans

    assert pfans(shape) == jfans(shape)


def test_other_initializers():
    from paddle_tpu.nn import initializer as jI

    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert pI.Assign(a)([2, 3]).tolist() == a.tolist()
    with pytest.raises(ValueError, match="shape"):
        pI.Assign(a)([3, 2])
    q = pI.Orthogonal(2.0)([6, 4]).double()
    assert torch.allclose(q.t() @ q, 4 * torch.eye(4, dtype=torch.float64),
                          atol=1e-5)
    d = pI.Dirac()([3, 2, 3, 3])
    np.testing.assert_array_equal(d.numpy(), np.asarray(
        jI.Dirac()([3, 2, 3, 3], "float32")))
    for nl, param in [("tanh", None), ("relu", None), ("leaky_relu", 0.2),
                      ("selu", None), ("conv2d", None)]:
        assert pI.calculate_gain(nl, param) == jI.calculate_gain(nl, param)
    t = torch.zeros(3, 4)
    assert pI.Constant(1.5)(t) is t and float(t.min()) == 1.5
    bf = pI.TruncatedNormal(0.0, 1.0)([64, 64], "bfloat16")
    assert bf.dtype == torch.bfloat16 and float(bf.abs().max()) <= 2.0


# -- the mp layers' attrs --------------------------------------------------------

def test_mp_layers_take_weight_and_bias_attr():
    from paddle_tpu_torch.distributed.meta_parallel import mp_layers as mp

    col = mp.ColumnParallelLinear(
        8, 6, weight_attr=P.ParamAttr(initializer=pI.Constant(0.5)),
        bias_attr=P.ParamAttr(initializer=pI.Constant(0.25)))
    row = mp.RowParallelLinear(6, 8, weight_attr=pI.Constant(-0.5),
                               bias_attr=False)
    emb = mp.VocabParallelEmbedding(
        16, 4, weight_attr=P.ParamAttr(initializer=pI.Constant(2.0),
                                       trainable=False))
    assert col.weight.shape == (6, 8) and float(col.weight.min()) == 0.5
    assert float(col.bias.max()) == 0.25
    assert row.bias is None and float(row.weight.max()) == -0.5
    assert float(emb.weight.min()) == 2.0 and not emb.weight.requires_grad
    x = torch.ones(2, 8)
    assert torch.allclose(row(col(x)), torch.full((2, 8), -0.5 * 6 * 4.25))

    P.seed(0)
    big = mp.ColumnParallelLinear(
        256, 512, weight_attr=P.ParamAttr(
            initializer=pI.TruncatedNormal(0.0, 0.02)))
    w = big.weight.detach()
    assert w.shape == (512, 256)
    assert float(w.abs().max()) <= 0.04 + 1e-7
    assert abs(float(w.std()) - 0.02 * 0.87962566) < 0.02 * 0.02
    assert abs(float(w.mean())) < 0.02 * 0.02
    # the full [in, out] weight's fans: XavierUniform's bound over 256 + 512
    xav = mp.RowParallelLinear(256, 512, weight_attr=pI.XavierUniform())
    bound = math.sqrt(6.0 / (256 + 512))
    assert float(xav.weight.abs().max()) <= bound
    assert float(xav.weight.abs().max()) > 0.99 * bound


@pytest.mark.parametrize("dim,to_port", [(0, "transposed"), (1, "transposed"),
                                         (0, "same")])
def test_mp_shard_of_the_full_draw(dim, to_port):
    """Under mp > 1 each rank keeps its shard of the same full draw."""
    from paddle_tpu_torch.distributed.meta_parallel import mp_layers as mp

    fn = mp._transposed if to_port == "transposed" else mp._same
    full_shape = [8, 6]
    P.seed(4)
    full = fn(pI.Normal()(full_shape))
    parts = []
    for r in range(2):
        shard = torch.empty(mp.mp_shard(full, 2, r, dim).shape)
        P.seed(4)
        mp._draw_attr(shard, P.ParamAttr(initializer=pI.Normal()),
                      full_shape, fn, dim, 2, r)
        parts.append(shard)
    assert torch.equal(torch.cat(parts, dim=dim), full)


@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_at_bert_shape_matches_jax(masked):
    """``F.scaled_dot_product_attention`` at BERT-base's attention (12
    heads of 64, 128 positions; batch cut to 2), not causal, with and
    without BERT's additive ``[b, 1, 1, s]`` mask: the flash kernels'
    plain version without it, the ``_sdpa_xla`` composition with it;
    output and the gradients of q, k and v within 1e-5."""
    b, s, h, d = 2, 128, 12, 64
    q, k, v = (f(b, s, h, d, lo=-1, hi=1, seed=i) for i in range(3))
    mask = None
    if masked:
        keep = np.ones((b, s), np.float32)
        keep[0, 100:] = 0
        mask = ((1.0 - keep) * -1e4)[:, None, None, :]
    jin = [J.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
    pin = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    jo = jF.scaled_dot_product_attention(
        *jin, attn_mask=None if mask is None else J.to_tensor(mask))
    po = pF.scaled_dot_product_attention(
        *pin, attn_mask=None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(_np(po), _np(jo), rtol=TOL, atol=TOL)
    w = np.random.default_rng(5).standard_normal((b, s, h, d)).astype(
        np.float32)
    J.sum(J.multiply(jo, J.to_tensor(w))).backward()
    (po * torch.tensor(w)).sum().backward()
    for ja, pa in zip(jin, pin):
        np.testing.assert_allclose(_np(pa.grad), _np(ja.grad), rtol=TOL,
                                   atol=TOL)
