"""The port's convolution, pooling and normalisation functionals and
layers, and ``vision.models.resnet18``, against the JAX package's.

Inputs and weights are drawn with numpy from a seed, in fp32 on the CPU.
Each functional runs over cases of stride, padding (ints, pairs, four
sides, 'SAME', 'VALID'), dilation, groups, ``NHWC``, ``ceil_mode``,
``count_include_pad`` (``exclusive=False``) and sizes that the window or
the bins do not divide; forward values and the gradients of
``sum(out * r)`` (a fixed random ``r``) with respect to every float input
are held to 1e-5 relative: elementwise 1e-5 |ref| + 1e-5 max |ref| over
the tensor (a gradient sums many terms that may cancel).

``ceil_mode`` and ``divisor_override`` have no effect in the JAX pooling
functions, and the port's match them (ROADMAP's oracle caveats); the
cases with ``ceil_mode=True`` at sizes that do not divide pin that.

``batch_norm`` in training moves its running buffers by paddle's momentum
and the biased batch variance; several calls are compared buffer by
buffer. ResNet-18 (full width, 10 classes, 32 x 32 surrogate images)
runs its forward in eval and training mode and three ``Momentum``
``TrainStep`` steps against the JAX ``jit.TrainStep`` (losses, every
parameter and every BatchNorm buffer), all within 1e-5 relative.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu import jit as jjit
from paddle_tpu.vision import models as jvm
import paddle_tpu_torch as P
import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import resnet_state_from_numpy
from paddle_tpu_torch.vision import models as pvm

RTOL = 1e-5


@pytest.fixture(autouse=True)
def cpu_place():
    prior = P.get_device()
    P.set_device("cpu")
    yield
    P.set_device(prior)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, ref, rtol=RTOL, msg=""):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * (float(np.nanmax(np.abs(ref)))
                                            + 1e-30), err_msg=msg)


def _both(jfn, pfn, arrays, grad=True, seed=99):
    """Runs ``jfn`` on JAX tensors and ``pfn`` on torch tensors of the same
    ``arrays`` (float ones take gradients), compares the outputs and the
    gradients of sum(out * r)."""
    jt = [J.to_tensor(a) for a in arrays]
    pt = [torch.from_numpy(a.copy()) for a in arrays]
    floats = [i for i, a in enumerate(arrays) if a.dtype == np.float32]
    if grad:
        for i in floats:
            jt[i].stop_gradient = False
            pt[i].requires_grad_()
    jout, pout = jfn(*jt), pfn(*pt)
    jouts = jout if isinstance(jout, (list, tuple)) else (jout,)
    pouts = pout if isinstance(pout, (list, tuple)) else (pout,)
    for k, (a, b) in enumerate(zip(pouts, jouts)):
        ref = np.asarray(b.numpy())
        if ref.dtype.kind in "iu":
            np.testing.assert_array_equal(a.numpy(), ref)
            assert str(a.dtype).split(".")[-1] == ref.dtype.name
        else:
            _close(a.detach().numpy(), ref, msg=f"output {k}")
    if not grad:
        return
    r = _rand(tuple(pouts[0].shape), seed)
    (jouts[0] * J.to_tensor(r)).sum().backward()
    (pouts[0] * torch.from_numpy(r)).sum().backward()
    for i in floats:
        _close(pt[i].grad.numpy(), np.asarray(jt[i].grad.numpy()),
               msg=f"grad {i}")


# -- convolutions ---------------------------------------------------------------

CONV2D = {
    "plain": dict(),
    "stride2_pad1": dict(stride=2, padding=1),
    "pad_pair": dict(padding=[1, 2]),
    "pad_four": dict(padding=[0, 2, 1, 0], stride=(2, 1)),
    "same_stride2": dict(padding="SAME", stride=2),
    "valid": dict(padding="VALID", stride=3),
    "dilation2": dict(dilation=2, padding=2),
    "groups2": dict(groups=2, padding=1),
    "depthwise": dict(groups=4, padding=1, stride=2),
    "nhwc": dict(data_format="NHWC", padding=1, stride=2),
}


@pytest.mark.parametrize("case", list(CONV2D))
@pytest.mark.parametrize("bias", [True, False])
def test_conv2d_matches_jax(case, bias):
    kw = dict(CONV2D[case])
    groups = kw.get("groups", 1)
    x = _rand((2, 4, 11, 9), 1)
    w = _rand((6 if groups != 4 else 4, 4 // groups, 3, 3), 2, 0.3)
    if kw.get("data_format") == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
        w = np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # HWIO
    arrays = [x, w] + ([_rand((w.shape[0] if kw.get("data_format") !=
                               "NHWC" else w.shape[3],), 3)] if bias else [])
    _both(lambda *a: JF.conv2d(*a, **kw), lambda *a: PF.conv2d(*a, **kw),
          arrays)


@pytest.mark.parametrize("kw", [dict(), dict(stride=2, padding=1),
                                dict(dilation=2, padding=2, groups=2)],
                         ids=["plain", "stride2", "dilation_groups"])
def test_conv1d_matches_jax(kw):
    x, w, b = _rand((2, 4, 13), 1), _rand((6, 4 // kw.get("groups", 1), 3),
                                           2, 0.3), _rand((6,), 3)
    _both(lambda *a: JF.conv1d(*a, **kw), lambda *a: PF.conv1d(*a, **kw),
          [x, w, b])


CONVT = {
    "plain": dict(),
    "stride2": dict(stride=2, padding=1),
    "output_padding": dict(stride=2, padding=1, output_padding=1),
    "groups_dilation": dict(groups=2, dilation=2, padding=1),
    "output_size": dict(stride=3, padding=1, output_size=[21, 17]),
    "nhwc": dict(stride=2, data_format="NHWC"),
}


@pytest.mark.parametrize("case", list(CONVT))
def test_conv2d_transpose_matches_jax(case):
    kw = dict(CONVT[case])
    g = kw.get("groups", 1)
    x = _rand((2, 4, 7, 6), 1)
    if kw.get("data_format") == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = _rand((4, 6 // g, 3, 3), 2, 0.3)
    b = _rand((6,), 3)
    _both(lambda *a: JF.conv2d_transpose(*a, **kw),
          lambda *a: PF.conv2d_transpose(*a, **kw), [x, w, b])


def test_conv2d_transpose_refuses_what_jax_refuses():
    x, w = torch.zeros(1, 2, 4, 4), torch.zeros(2, 2, 3, 3)
    with pytest.raises(ValueError):
        PF.conv2d_transpose(x, w, stride=2, output_padding=1,
                            output_size=[9, 9])
    with pytest.raises(ValueError):
        PF.conv2d_transpose(x, w, stride=2, output_size=[20, 20])


# -- pooling --------------------------------------------------------------------

MAXPOOL = {
    "k2": dict(kernel_size=2),
    "k3_s2_p1": dict(kernel_size=3, stride=2, padding=1),
    "k3_s2_ceil": dict(kernel_size=3, stride=2, ceil_mode=True),
    "k2x3_s1x2": dict(kernel_size=(2, 3), stride=(1, 2)),
    "pad_past_half": dict(kernel_size=2, stride=2, padding=2),
    "nhwc": dict(kernel_size=3, stride=2, padding=1, data_format="NHWC"),
    "mask": dict(kernel_size=3, stride=2, padding=1, return_mask=True),
    "mask_pad_past_half": dict(kernel_size=2, stride=1, padding=2,
                               return_mask=True),
}


@pytest.mark.parametrize("case", list(MAXPOOL))
def test_max_pool2d_matches_jax(case):
    kw = MAXPOOL[case]
    x = _rand((2, 3, 11, 10), 4)
    if kw.get("data_format") == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    _both(lambda a: JF.max_pool2d(a, **kw), lambda a: PF.max_pool2d(a, **kw),
          [x])


AVGPOOL = {
    "k2": dict(kernel_size=2),
    "k3_s2_p1_exclusive": dict(kernel_size=3, stride=2, padding=1),
    "k3_s2_p1_count_pad": dict(kernel_size=3, stride=2, padding=1,
                               exclusive=False),
    "k3_s2_ceil": dict(kernel_size=3, stride=2, ceil_mode=True),
    "k2x3": dict(kernel_size=(2, 3), stride=(2, 1), padding=(1, 1)),
    "pad_past_half_exclusive": dict(kernel_size=2, stride=2, padding=2),
    "pad_past_half_count_pad": dict(kernel_size=2, stride=2, padding=2,
                                    exclusive=False),
    "nhwc": dict(kernel_size=3, stride=2, padding=1, data_format="NHWC"),
    "divisor_override": dict(kernel_size=2, divisor_override=3),
}


@pytest.mark.parametrize("case", list(AVGPOOL))
def test_avg_pool2d_matches_jax(case):
    kw = AVGPOOL[case]
    x = _rand((2, 3, 11, 10), 5)
    if kw.get("data_format") == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    _both(lambda a: JF.avg_pool2d(a, **kw), lambda a: PF.avg_pool2d(a, **kw),
          [x])


@pytest.mark.parametrize("out", [(1, 1), (2, 5), (3, 4), (5, 3), 4],
                         ids=["1x1", "divides", "3x4", "5x3", "4"])
@pytest.mark.parametrize("kind", ["avg", "max", "max_mask"])
def test_adaptive_pool2d_matches_jax(kind, out):
    x = _rand((2, 3, 10, 10 if out != (5, 3) else 7), 6)
    if kind == "avg":
        jf = lambda a: JF.adaptive_avg_pool2d(a, out)  # noqa: E731
        pf = lambda a: PF.adaptive_avg_pool2d(a, out)  # noqa: E731
    else:
        kw = dict(return_mask=kind == "max_mask")
        jf = lambda a: JF.adaptive_max_pool2d(a, out, **kw)  # noqa: E731
        pf = lambda a: PF.adaptive_max_pool2d(a, out, **kw)  # noqa: E731
    _both(jf, pf, [x])


def test_adaptive_bins_match_jax():
    from paddle_tpu.nn.functional import common as jc
    from paddle_tpu_torch.nn.functional import common as pc

    for size in range(1, 12):
        for out in range(1, 12):
            assert pc._adaptive_bins(size, out) == \
                jc._adaptive_bins(size, out)


# -- normalisation --------------------------------------------------------------

@pytest.mark.parametrize("data_format", ["NCHW", "NHWC", "NC", "NCL"])
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_and_running_buffers_match_jax(training, data_format):
    """Three calls with fresh inputs; the output and gradients of the last,
    and the running buffers after each, against the JAX function
    (momentum 0.8, paddle's sense)."""
    shape = {"NCHW": (4, 3, 5, 6), "NHWC": (4, 5, 6, 3), "NC": (6, 3),
             "NCL": (4, 3, 7)}[data_format]
    c = 3
    rm, rv = _rand((c,), 10, 0.1), 1.0 + np.abs(_rand((c,), 11, 0.2))
    jrm, jrv = J.to_tensor(rm), J.to_tensor(rv)
    prm, prv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    w, b = 1.0 + _rand((c,), 12, 0.1), _rand((c,), 13, 0.1)
    for i in range(3):
        x = _rand(shape, 20 + i, 2.0) + 0.5
        _both(lambda a, ww, bb: JF.batch_norm(
                  a, jrm, jrv, ww, bb, training=training, momentum=0.8,
                  epsilon=1e-5, data_format=data_format),
              lambda a, ww, bb: PF.batch_norm(
                  a, prm, prv, ww, bb, training=training, momentum=0.8,
                  epsilon=1e-5, data_format=data_format),
              [x, w, b], grad=i == 2)
        _close(prm.numpy(), np.asarray(jrm.numpy()), msg=f"mean {i}")
        _close(prv.numpy(), np.asarray(jrv.numpy()), msg=f"variance {i}")
    moved = not np.allclose(prm.numpy(), rm)
    assert moved == training


def test_batch_norm_update_is_biased_with_paddles_momentum():
    x = torch.tensor([[1.0], [2.0], [4.0]])
    rm, rv = torch.zeros(1), torch.ones(1)
    PF.batch_norm(x, rm, rv, None, None, training=True, momentum=0.9)
    mean, var = 7.0 / 3.0, float(((x - 7.0 / 3.0) ** 2).mean())
    assert math.isclose(float(rm), 0.1 * mean, rel_tol=1e-6)
    assert math.isclose(float(rv), 0.9 + 0.1 * var, rel_tol=1e-6)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_group_norm_matches_jax(groups):
    _both(lambda a, w, b: JF.group_norm(a, groups, w, b, epsilon=1e-5),
          lambda a, w, b: PF.group_norm(a, groups, w, b, epsilon=1e-5),
          [_rand((2, 4, 5, 3), 30), 1 + _rand((4,), 31, 0.1),
           _rand((4,), 32, 0.1)])


@pytest.mark.parametrize("shape", [(2, 3, 5, 4), (2, 3, 7)], ids=["2d", "1d"])
def test_instance_norm_matches_jax(shape):
    _both(lambda a, w, b: JF.instance_norm(a, weight=w, bias=b, eps=1e-5),
          lambda a, w, b: PF.instance_norm(a, weight=w, bias=b, eps=1e-5),
          [_rand(shape, 33), 1 + _rand((3,), 34, 0.1), _rand((3,), 35, 0.1)])


@pytest.mark.parametrize("shape", [(2, 6, 4, 3), (2, 5, 7)],
                         ids=["4d", "3d"])
@pytest.mark.parametrize("size", [3, 4])
def test_local_response_norm_matches_jax(size, shape):
    _both(lambda a: JF.local_response_norm(a, size, alpha=1e-2),
          lambda a: PF.local_response_norm(a, size, alpha=1e-2),
          [_rand(shape, 37, 2.0)])


@pytest.mark.parametrize("size", [3, 4, 5])
def test_local_response_norm_layer_matches_jax(size):
    x = _rand((2, 6, 4, 3), 36, 2.0)
    jl, pl = jnn.LocalResponseNorm(size, alpha=1e-2), \
        pnn.LocalResponseNorm(size, alpha=1e-2)
    _both(jl, pl, [x])


# -- layers ---------------------------------------------------------------------

LAYERS = {
    "conv2d": (lambda nn: nn.Conv2D(6, 8, 3, stride=2, padding=1, groups=2),
               (2, 6, 9, 9)),
    "conv2d_nobias": (lambda nn: nn.Conv2D(3, 4, (3, 5), bias_attr=False),
                      (2, 3, 8, 9)),
    "conv1d": (lambda nn: nn.Conv1D(4, 6, 3, padding=1), (2, 4, 10)),
    "conv2d_transpose": (lambda nn: nn.Conv2DTranspose(4, 6, 3, stride=2,
                                                       padding=1),
                         (2, 4, 5, 5)),
    "maxpool": (lambda nn: nn.MaxPool2D(3, stride=2, padding=1,
                                        ceil_mode=True), (2, 3, 9, 8)),
    "avgpool": (lambda nn: nn.AvgPool2D(3, stride=2, padding=1,
                                        exclusive=False), (2, 3, 9, 8)),
    "adaptive_avg": (lambda nn: nn.AdaptiveAvgPool2D((3, 2)), (2, 3, 7, 5)),
    "adaptive_max": (lambda nn: nn.AdaptiveMaxPool2D(3), (2, 3, 7, 5)),
    "batchnorm2d": (lambda nn: nn.BatchNorm2D(3, momentum=0.7), (4, 3, 5, 5)),
    "batchnorm1d": (lambda nn: nn.BatchNorm1D(3), (6, 3)),
    "batchnorm_act": (lambda nn: nn.BatchNorm(3, act="relu"), (4, 3, 4, 4)),
    "batchnorm_nhwc": (lambda nn: nn.BatchNorm2D(3, data_format="NHWC"),
                       (4, 5, 5, 3)),
    "syncbatchnorm": (lambda nn: nn.SyncBatchNorm(3), (4, 3, 5, 5)),
    "groupnorm": (lambda nn: nn.GroupNorm(2, 4), (2, 4, 3, 3)),
    "instancenorm": (lambda nn: nn.InstanceNorm2D(3), (2, 3, 4, 4)),
}


def _layer_pair(case, seed=0):
    """The JAX layer and the port's with the JAX one's (perturbed) state."""
    make, shape = LAYERS[case]
    J.seed(seed)
    jl = make(jnn)
    pl = make(pnn)
    rng = np.random.default_rng(seed)
    state = {}
    for name, v in jl.state_dict().items():
        a = np.asarray(v.numpy())
        state[name] = (a + 0.1 * rng.standard_normal(a.shape)).astype(
            np.float32) if name != "_variance" else \
            (a + 0.1 * np.abs(rng.standard_normal(a.shape))).astype(
                np.float32)
    jl.set_state_dict(state)
    missing, unexpected = pl.set_state_dict(state)
    assert not missing and not unexpected
    return jl, pl, shape


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("case", list(LAYERS))
def test_layer_matches_jax(case, training):
    jl, pl, shape = _layer_pair(case)
    for m in (jl, pl):
        m.train() if training else m.eval()
    x = _rand(shape, 40)
    jp = dict(jl.named_parameters())
    _both(jl, pl, [x])
    for name, p in pl.named_parameters():
        if p.requires_grad:
            _close(p.grad.numpy(), np.asarray(jp[name].grad.numpy()),
                   msg=name)
    jsd = jl.state_dict()
    for name, v in pl.state_dict().items():
        _close(v.numpy(), np.asarray(jsd[name].numpy()), msg=name)


@pytest.mark.parametrize("case", ["conv2d", "conv2d_nobias", "conv1d",
                                  "conv2d_transpose", "batchnorm2d",
                                  "groupnorm", "instancenorm"])
def test_layer_parameters_and_initializers_match_jax(case):
    """Names and shapes equal the JAX layer's; a conv weight is uniform in
    +-sqrt(6 / fan_in) and its bias in +-1 / sqrt(fan_in) (mean and
    variance within 5 sigma of the uniform law's over the draw), with
    fan_in = in / groups * prod(k) (``Conv2DTranspose``: in * kh * kw, and
    a zero bias); norms start at weight 1, bias 0, running mean 0 and
    variance 1."""
    make, _shape = LAYERS[case]
    J.seed(0)
    jl = make(jnn)
    P.seed(0)
    pl = make(pnn)
    jsd, psd = jl.state_dict(), pl.state_dict()
    assert sorted(jsd) == sorted(psd)
    for k, v in jsd.items():
        assert tuple(v.shape) == tuple(psd[k].shape), k
    for name, t in psd.items():
        a = t.numpy()
        if case.startswith("conv"):
            w = psd["weight"].numpy()
            fan = w.shape[0 if case == "conv2d_transpose" else 1] * \
                int(np.prod(w.shape[2:]))
            if case == "conv2d_transpose" and name == "bias":
                assert (a == 0).all()
                continue
            bound = math.sqrt(6.0 / fan) if name == "weight" else \
                1.0 / math.sqrt(fan)
            var, n = bound ** 2 / 3, a.size
            assert np.abs(a).max() <= bound, name
            assert abs(a.mean()) < 5 * math.sqrt(var / n), name
            assert abs(a.var() - var) < 5 * var * math.sqrt(0.8 / n), name
        elif name in ("weight", "scale", "_variance"):
            assert (a == 1).all(), name
        else:
            assert (a == 0).all(), name


def test_batchnorm_weight_attr_false_takes_no_gradient():
    bn = pnn.BatchNorm2D(3, weight_attr=False, bias_attr=False)
    assert not bn.weight.requires_grad and not bn.bias.requires_grad
    assert (bn.weight == 1).all() and (bn.bias == 0).all()


def test_sync_batchnorm_converts_and_refuses_data_ranks(monkeypatch):
    net = pnn.Sequential(pnn.Conv2D(3, 4, 3), pnn.BatchNorm2D(4),
                         pnn.Sequential(pnn.BatchNorm1D(4)))
    with torch.no_grad():
        net[1]._mean.fill_(0.5)
    out = pnn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert out is net and isinstance(net[1], pnn.SyncBatchNorm)
    assert isinstance(net[2][0], pnn.SyncBatchNorm)
    assert float(net[1]._mean[0]) == 0.5
    from paddle_tpu_torch.distributed import mesh as pmesh

    class _Env:
        degrees = {"dp": 2, "sdp": 1}

    monkeypatch.setitem(pmesh._GLOBAL, "env", _Env())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        net[1](torch.zeros(2, 4, 3, 3))


@pytest.mark.parametrize("dim,iters", [(0, 1), (1, 2)])
def test_spectral_norm_matches_jax(dim, iters):
    """The layer the JAX package exports as ``nn.SpectralNorm``: the same
    held u, v and weight give the same normalised weight and gradient."""
    shape = [4, 3, 2]
    J.seed(0)
    jl = jnn.SpectralNorm(shape, dim=dim, power_iters=iters)
    pl = pnn.SpectralNorm(shape, dim=dim, power_iters=iters)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert sorted(state) == sorted(pl.state_dict()) == ["weight_u",
                                                        "weight_v"]
    pl.set_state_dict(state)
    assert not pl.weight_u.requires_grad and not pl.weight_v.requires_grad
    _both(jl, pl, [_rand(shape, 41)])


# -- ResNet ---------------------------------------------------------------------

def _resnet_pair(seed=7):
    """resnet18(num_classes=10) in both packages with the JAX model's own
    draw, its BatchNorm weights, biases and buffers perturbed."""
    J.seed(seed)
    jm = jvm.resnet18(num_classes=10)
    rng = np.random.default_rng(seed)
    state = {}
    for name, v in jm.state_dict().items():
        a = np.asarray(v.numpy()).astype(np.float32)
        leaf = name.rsplit(".", 1)[-1]
        if "bn" in name or "downsample.1" in name:
            noise = 0.1 * rng.standard_normal(a.shape)
            a = a + (np.abs(noise) if leaf == "_variance" else noise)
        state[name] = a.astype(np.float32)
    jm.set_state_dict(state)
    pm = pvm.resnet18(num_classes=10)
    missing, unexpected = pm.set_state_dict(resnet_state_from_numpy(state))
    assert not missing and not unexpected
    return jm, pm


def _cifar(n, seed):
    """A CIFAR-10 stand-in: 10 class prototypes plus noise, 32 x 32 (the
    rule of ``bench.py``'s ``_surrogate_cifar``)."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(10, 3, 32, 32).astype("float32")
    ys = rng.randint(0, 10, n).astype("int64")
    xs = (protos[ys] + 0.7 * rng.randn(n, 3, 32, 32)).astype("float32")
    return xs, ys


def test_resnet18_names_shapes_and_count():
    jm, pm = _resnet_pair()
    jsd, psd = jm.state_dict(), pm.state_dict()
    assert sorted(jsd) == sorted(psd)
    for k, v in jsd.items():
        assert tuple(v.shape) == tuple(psd[k].shape), k
    assert sum(p.numel() for p in pm.parameters()) == 11181642


@pytest.mark.parametrize("training", [False, True])
def test_resnet18_forward_matches_jax(training):
    """Logits (and in training the BatchNorm buffers the forward moves)."""
    jm, pm = _resnet_pair()
    for m in (jm, pm):
        m.train() if training else m.eval()
    x, _y = _cifar(4, 1)
    ref = np.asarray(jm(J.to_tensor(x)).numpy())
    got = pm(torch.from_numpy(x)).detach().numpy()
    _close(got, ref)
    jsd = jm.state_dict()
    for name, v in pm.state_dict().items():
        _close(v.numpy(), np.asarray(jsd[name].numpy()), msg=name)


def test_resnet18_three_momentum_steps_match_jax():
    """Three ``TrainStep`` steps of ``bench.py``'s CPU-reference recipe
    (``_resnet_cifar_losses``: Momentum lr 0.01 / 0.9, batch 32 of the 32 x
    32 surrogate): losses, every parameter and every BatchNorm buffer
    within 1e-5 relative. (At batches of 4 to 16 BatchNorm over layer4's 1
    x 1 maps of a few samples makes the step so ill-conditioned that two
    fp32 runs of the same function, or fp32 against fp64, part by 1e-2
    within three steps; at lr 0.05 likewise.)

    The JAX ``jit.TrainStep`` threads the buffers into its step as frozen
    inputs and never writes the running statistics back (ROADMAP's oracle
    caveats), where paddle, the JAX eager path and the port move them. So
    before each step the JAX model's own eager forward on the step's batch
    moves its buffers (in training mode they do not enter the loss)."""
    jm, pm = _resnet_pair()
    lr = 0.01
    jo = jopt.Momentum(learning_rate=lr, momentum=0.9,
                       parameters=jm.parameters())
    po = popt.Momentum(learning_rate=lr, momentum=0.9,
                       parameters=pm.parameters())
    jstep = jjit.TrainStep(jm, lambda m, x, y: JF.cross_entropy(m(x), y), jo)
    pstep = TrainStep(pm, lambda m, x, y: PF.cross_entropy(m(x), y), po)
    xs, ys = _cifar(96, 2)
    jm.train()
    ref, got = [], []
    for i in range(3):
        x, y = xs[32 * i:32 * i + 32], ys[32 * i:32 * i + 32]
        with J.no_grad():
            jm(J.to_tensor(x))
        ref.append(float(jstep(J.to_tensor(x), J.to_tensor(y))))
        got.append(float(pstep(torch.from_numpy(x), torch.from_numpy(y))))
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    assert ref[-1] < ref[0]
    jsd = jm.state_dict()
    for name, v in pm.state_dict().items():
        _close(v.detach().numpy(), np.asarray(jsd[name].numpy()), msg=name)


def test_resnet_factories_and_pretrained_raises():
    with pytest.raises(ValueError, match="download"):
        pvm.resnet18(pretrained=True)
    m = pvm.resnet50(num_classes=0, with_pool=False)
    assert not hasattr(m, "fc")
    assert isinstance(pvm.resnext50_32x4d().layer1[0].conv2, pnn.Conv2D)
    assert pvm.resnext50_32x4d().layer1[0].conv2._groups == 32
    assert pvm.wide_resnet50_2().layer1[0].conv1.weight.shape[0] == 128
