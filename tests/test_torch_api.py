"""The port's op namespace against the JAX package's, op by op.

Each case calls ``paddle_tpu.<name>`` and ``paddle_tpu_torch.<name>`` on
the same numpy inputs (made from a seed). Integer and bool results must be
equal; floating ones agree within 1e-6 relative (and 1e-6 absolute, for
values near 0). Shapes are equal, and dtypes equal through the JAX
package's narrowing of 64-bit types to 32 (it runs without x64). Where the
op is differentiable, the gradient of ``sum(out * w)`` (``w`` drawn from
the seed) with respect to every floating input goes through the JAX
package's ``.backward()`` and torch's autograd, within 1e-5 (an input the
output does not depend on counts as a zero gradient). The random creation
ops draw from different generators in the two packages (threefry and
torch's), so their cases check shapes, dtypes and ranges instead.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P

RTOL, ATOL = 1e-6, 1e-6
GRAD_TOL = 1e-5

_NARROW = {"int64": "int32", "float64": "float32", "complex128": "complex64",
           "uint64": "uint32"}


@pytest.fixture(autouse=True)
def cpu_place():
    prior = P.get_device()
    P.set_device("cpu")
    yield
    P.set_device(prior)


def _rng(seed=0):
    return np.random.default_rng(seed)


def f(*shape, lo=-2.0, hi=2.0, seed=0):
    return _rng(seed).uniform(lo, hi, shape).astype(np.float32)


def ints(*shape, lo=-5, hi=6, seed=1):
    return _rng(seed).integers(lo, hi, shape).astype(np.int64)


def bools(*shape, seed=2):
    return _rng(seed).random(shape) < 0.5


def distinct(*shape, seed=3):
    """Floats without ties (for sorts, top-k and arg-reductions)."""
    n = int(np.prod(shape))
    return (_rng(seed).permutation(n).astype(np.float32) / n - 0.5).reshape(
        shape) * 4


def _to_jax(a, diff):
    if isinstance(a, np.ndarray):
        return J.to_tensor(a, stop_gradient=not (diff and a.dtype.kind == "f"))
    if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
        return [_to_jax(e, diff) for e in a]
    if isinstance(a, tuple) and a and isinstance(a[0], np.ndarray):
        return tuple(_to_jax(e, diff) for e in a)
    return a


def _to_port(a, diff):
    if isinstance(a, np.ndarray):
        t = torch.tensor(a)
        if diff and a.dtype.kind == "f":
            t.requires_grad_(True)
        return t
    if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
        return [_to_port(e, diff) for e in a]
    if isinstance(a, tuple) and a and isinstance(a[0], np.ndarray):
        return tuple(_to_port(e, diff) for e in a)
    return a


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [y for e in x for y in _leaves(e)]
    return [x]


def _np_jax(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _np_port(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(t)


def _narrow(name):
    return _NARROW.get(name, name)


def assert_same(got, ref, tol=(RTOL, ATOL)):
    g, r = _np_port(got), _np_jax(ref)
    assert g.shape == r.shape, (g.shape, r.shape)
    assert _narrow(g.dtype.name) == r.dtype.name, (g.dtype, r.dtype)
    if g.dtype.kind in "biu":
        np.testing.assert_array_equal(g, r)
    else:
        np.testing.assert_allclose(g, r, rtol=tol[0], atol=tol[1])


def _floating_inputs(args):
    return [a for a in _leaves(list(args))
            if isinstance(a, (torch.Tensor,)) and a.requires_grad]


def _check_grads(jouts, pouts, jargs, pargs, seed=7):
    """The gradient of sum(out * w) over every floating output."""
    pairs = [(j, p) for j, p in zip(_leaves(jouts), _leaves(pouts))
             if isinstance(p, torch.Tensor) and p.dtype.is_floating_point
             and p.requires_grad]
    if not pairs:
        return
    rng = _rng(seed)
    jtotal, ptotal = None, None
    for j, p in pairs:
        w = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        jt = J.sum(J.multiply(j, J.to_tensor(w)))
        pt = (p * torch.tensor(w)).sum()
        jtotal = jt if jtotal is None else J.add(jtotal, jt)
        ptotal = pt if ptotal is None else ptotal + pt
    jtotal.backward()
    ptotal.backward()
    jl = [a for a in _leaves(list(jargs)) if hasattr(a, "stop_gradient")
          and not a.stop_gradient]
    pl = _floating_inputs(pargs)
    assert len(jl) == len(pl)
    for ja, pa in zip(jl, pl):
        jg = np.zeros(tuple(pa.shape), np.float32) if ja.grad is None else \
            _np_jax(ja.grad)
        pg = np.zeros(tuple(pa.shape), np.float32) if pa.grad is None else \
            _np_port(pa.grad)
        np.testing.assert_allclose(pg, jg, rtol=GRAD_TOL, atol=GRAD_TOL)


def run_case(name, make, kwargs, diff):
    args = make()
    jargs = [_to_jax(a, diff) for a in args]
    pargs = [_to_port(a, diff) for a in args]
    jout = getattr(J, name)(*jargs, **kwargs)
    pout = getattr(P, name)(*pargs, **kwargs)
    jl, pl = _leaves(jout), _leaves(pout)
    assert len(jl) == len(pl), (len(jl), len(pl))
    for j, p in zip(jl, pl):
        assert_same(p, j)
    if diff:
        _check_grads(jout, pout, jargs, pargs)


# (case id, op name, inputs, kwargs, differentiable)
MATH = [
    ("add", "add", lambda: [f(3, 4), f(3, 4, seed=1)], {}, True),
    ("add-bcast", "add", lambda: [f(3, 4), f(4, seed=1)], {}, True),
    ("add-int", "add", lambda: [ints(3, 4), ints(3, 4, seed=2)], {}, False),
    ("add-scalar", "add", lambda: [f(3, 4), 2], {}, True),
    ("add-int-float-scalar", "add", lambda: [ints(3, 4), 2.5], {}, False),
    ("subtract", "subtract", lambda: [f(3, 4), f(3, 4, seed=1)], {}, True),
    ("multiply", "multiply", lambda: [f(3, 4), f(3, 4, seed=1)], {}, True),
    ("multiply-scalar-left", "multiply", lambda: [3.0, f(3, 4)], {}, True),
    ("divide", "divide", lambda: [f(3, 4), f(3, 4, lo=0.5, seed=1)], {},
     True),
    ("divide-int", "divide", lambda: [ints(3, 4), ints(3, 4, lo=1, seed=2)],
     {}, False),
    ("floor_divide", "floor_divide",
     lambda: [f(3, 4), f(3, 4, lo=0.5, seed=1)], {}, False),
    ("floor_divide-int", "floor_divide",
     lambda: [ints(3, 4), ints(3, 4, lo=1, seed=2)], {}, False),
    ("remainder", "remainder", lambda: [f(3, 4), f(3, 4, lo=0.5, seed=1)],
     {}, True),
    ("remainder-int", "remainder",
     lambda: [ints(3, 4), ints(3, 4, lo=1, seed=2)], {}, False),
    ("mod", "mod", lambda: [ints(3, 4), ints(3, 4, lo=1, seed=2)], {}, False),
    ("floor_mod", "floor_mod", lambda: [f(3, 4), f(3, 4, lo=0.5, seed=1)],
     {}, True),
    ("pow", "pow", lambda: [f(3, 4, lo=0.5), f(3, 4, seed=1)], {}, True),
    ("pow-scalar", "pow", lambda: [f(3, 4), 3], {}, True),
    ("maximum", "maximum", lambda: [f(3, 4), f(3, 4, seed=1)], {}, True),
    ("minimum", "minimum", lambda: [f(3, 4), f(3, 4, seed=1)], {}, True),
    ("fmax", "fmax", lambda: [f(3, 4), f(3, 4, seed=1)], {}, True),
    ("fmin", "fmin", lambda: [f(3, 4), f(3, 4, seed=1)], {}, True),
    ("atan2", "atan2", lambda: [f(3, 4), f(3, 4, seed=1)], {}, True),
    ("heaviside", "heaviside", lambda: [f(3, 4), f(3, 4, seed=1)], {},
     False),
    ("logaddexp", "logaddexp", lambda: [f(3, 4), f(3, 4, seed=1)], {}, True),
    ("hypot", "hypot", lambda: [f(3, 4), f(3, 4, seed=1)], {}, True),
    ("copysign", "copysign", lambda: [f(3, 4), f(3, 4, seed=1)], {}, False),
    ("gcd", "gcd", lambda: [ints(3, 4, lo=1, hi=40), ints(3, 4, lo=1, hi=40,
                                                          seed=2)], {},
     False),
    ("lcm", "lcm", lambda: [ints(3, 4, lo=1, hi=20), ints(3, 4, lo=1, hi=20,
                                                          seed=2)], {},
     False),
]
for _u in ["exp", "expm1", "sin", "cos", "tan", "atan", "sinh", "cosh",
           "tanh", "asinh", "abs", "neg", "negative", "square", "erf",
           "sigmoid", "floor", "ceil", "round", "trunc", "frac", "sign",
           "rad2deg", "deg2rad", "i0"]:
    MATH.append((_u, _u, lambda: [f(3, 5, seed=4)], {}, True))
for _u in ["log", "log2", "log10", "log1p", "sqrt", "rsqrt", "reciprocal",
           "lgamma", "digamma", "acosh"]:
    MATH.append((_u, _u, lambda: [f(3, 5, lo=1.1, hi=3.0, seed=4)], {}, True))
for _u in ["asin", "acos", "atanh", "erfinv"]:
    MATH.append((_u, _u, lambda: [f(3, 5, lo=-0.9, hi=0.9, seed=4)], {},
                 True))
MATH += [
    ("logit", "logit", lambda: [f(3, 5, lo=0.1, hi=0.9)], {}, True),
    ("conj", "conj", lambda: [f(3, 4)], {}, True),
    ("real", "real", lambda: [f(3, 4)], {}, True),
    ("imag", "imag", lambda: [f(3, 4)], {}, True),
    ("angle", "angle", lambda: [f(3, 4)], {}, False),
    ("abs-int", "abs", lambda: [ints(3, 4)], {}, False),
    ("isnan", "isnan", lambda: [np.array([1.0, np.nan, np.inf, -np.inf],
                                         np.float32)], {}, False),
    ("isinf", "isinf", lambda: [np.array([1.0, np.nan, np.inf, -np.inf],
                                         np.float32)], {}, False),
    ("isfinite", "isfinite", lambda: [np.array([1.0, np.nan, np.inf,
                                                -np.inf], np.float32)], {},
     False),
    ("logical_and", "logical_and", lambda: [bools(3, 4), bools(3, 4, seed=5)],
     {}, False),
    ("logical_or", "logical_or", lambda: [bools(3, 4), bools(3, 4, seed=5)],
     {}, False),
    ("logical_xor", "logical_xor", lambda: [bools(3, 4), bools(3, 4, seed=5)],
     {}, False),
    ("logical_not", "logical_not", lambda: [bools(3, 4)], {}, False),
    ("bitwise_and", "bitwise_and", lambda: [ints(3, 4), ints(3, 4, seed=5)],
     {}, False),
    ("bitwise_or", "bitwise_or", lambda: [ints(3, 4), ints(3, 4, seed=5)],
     {}, False),
    ("bitwise_xor", "bitwise_xor", lambda: [ints(3, 4), ints(3, 4, seed=5)],
     {}, False),
    ("bitwise_not", "bitwise_not", lambda: [ints(3, 4)], {}, False),
    ("scale", "scale", lambda: [f(3, 4)], dict(scale=2.5, bias=0.5), True),
    ("scale-before", "scale", lambda: [f(3, 4)],
     dict(scale=2.5, bias=0.5, bias_after_scale=False), True),
    ("clip", "clip", lambda: [f(3, 4)], dict(min=-0.5, max=0.7), True),
    ("clip-min-only", "clip", lambda: [f(3, 4)], dict(min=-0.5), True),
    ("cumsum", "cumsum", lambda: [f(3, 4)], dict(axis=1), True),
    ("cumsum-flat", "cumsum", lambda: [f(3, 4)], {}, True),
    ("cumsum-int", "cumsum", lambda: [ints(3, 4)], dict(axis=0), False),
    ("cumprod", "cumprod", lambda: [f(3, 4, lo=0.5)], dict(dim=1), True),
    ("lerp", "lerp", lambda: [f(3, 4), f(3, 4, seed=1)], dict(weight=0.3),
     True),
    ("lerp-tensor", "lerp", lambda: [f(3, 4), f(3, 4, seed=1),
                                     f(3, 4, lo=0, hi=1, seed=2)], {}, True),
    ("kron", "kron", lambda: [f(2, 3), f(3, 2, seed=1)], {}, True),
    ("trace", "trace", lambda: [f(4, 5)], dict(offset=1), True),
    ("diff", "diff", lambda: [f(3, 6)], dict(n=2, axis=1), True),
    ("nan_to_num", "nan_to_num",
     lambda: [np.array([1.0, np.nan, np.inf, -np.inf], np.float32)],
     dict(nan=0.5, posinf=9.0, neginf=-9.0), False),
    ("add_n", "add_n", lambda: [[f(3, 4), f(3, 4, seed=1), f(3, 4, seed=2)]],
     {}, True),
    ("stanh", "stanh", lambda: [f(3, 4)], {}, True),
    ("multiply_add", "multiply_add",
     lambda: [f(3, 4), f(3, 4, seed=1), f(3, 4, seed=2)], {}, True),
    ("increment", "increment", lambda: [f(3, 4)], dict(value=2.0), True),
    ("renorm", "renorm", lambda: [f(3, 4)], dict(p=2, axis=0, max_norm=1.5),
     True),
]

COMPARISON = [
    (n, n, lambda: [ints(3, 4), ints(3, 4, seed=5)], {}, False)
    for n in ["equal", "not_equal", "greater_than", "greater_equal",
              "less_than", "less_equal"]
] + [
    ("equal-float-scalar", "equal", lambda: [np.array([1.0, 2.0, 3.0],
                                                      np.float32), 2.0], {},
     False),
    ("less_than-scalar", "less_than", lambda: [f(3, 4), 0.25], {}, False),
    ("allclose", "allclose", lambda: [f(3, 4), f(3, 4) + 1e-7], {}, False),
    ("allclose-false", "allclose", lambda: [f(3, 4), f(3, 4, seed=1)], {},
     False),
    ("isclose", "isclose", lambda: [f(3, 4), f(3, 4) + np.float32(1e-3) *
                                    bools(3, 4)], dict(atol=1e-4), False),
    ("equal_all", "equal_all", lambda: [ints(3, 4), ints(3, 4)], {}, False),
    ("equal_all-false", "equal_all", lambda: [ints(3, 4), ints(3, 4, seed=4)],
     {}, False),
    ("is_empty", "is_empty", lambda: [np.zeros((0, 3), np.float32)], {},
     False),
]

REDUCTION = [
    ("sum", "sum", lambda: [f(3, 4, 5)], {}, True),
    ("sum-axis", "sum", lambda: [f(3, 4, 5)], dict(axis=1), True),
    ("sum-axes-keepdim", "sum", lambda: [f(3, 4, 5)],
     dict(axis=[0, 2], keepdim=True), True),
    ("sum-int", "sum", lambda: [ints(3, 4)], dict(axis=0), False),
    ("sum-bool", "sum", lambda: [bools(3, 4)], {}, False),
    ("mean", "mean", lambda: [f(3, 4, 5)], dict(axis=-1), True),
    ("mean-all", "mean", lambda: [f(3, 4, 5)], {}, True),
    ("prod", "prod", lambda: [f(3, 4, lo=0.5)], dict(axis=1), True),
    ("prod-axes", "prod", lambda: [f(2, 3, 4, lo=0.5)], dict(axis=[0, 2]),
     True),
    ("max", "max", lambda: [distinct(3, 4, 5)], dict(axis=1), True),
    ("max-all", "max", lambda: [distinct(3, 4)], {}, True),
    ("min", "min", lambda: [distinct(3, 4, 5)], dict(axis=[0, 2],
                                                     keepdim=True), True),
    ("amax", "amax", lambda: [distinct(3, 4)], dict(axis=0), True),
    ("amin", "amin", lambda: [distinct(3, 4)], dict(axis=-1), True),
    ("all", "all", lambda: [bools(3, 4)], dict(axis=1), False),
    ("any", "any", lambda: [bools(3, 4)], dict(axis=0), False),
    ("any-all", "any", lambda: [bools(3, 4)], {}, False),
    ("logsumexp", "logsumexp", lambda: [f(3, 4, 5)], dict(axis=-1), True),
    ("logsumexp-all", "logsumexp", lambda: [f(3, 4)], {}, True),
    ("std", "std", lambda: [f(3, 6)], dict(axis=1), True),
    ("std-biased", "std", lambda: [f(3, 6)], dict(unbiased=False), True),
    ("var", "var", lambda: [f(3, 6)], dict(axis=0, keepdim=True), True),
    ("argmax", "argmax", lambda: [distinct(3, 5)], dict(axis=1), False),
    ("argmax-flat", "argmax", lambda: [distinct(3, 5)], {}, False),
    ("argmin", "argmin", lambda: [distinct(3, 5)],
     dict(axis=0, keepdim=True), False),
    ("median", "median", lambda: [distinct(3, 6)], dict(axis=1), True),
    ("median-odd", "median", lambda: [distinct(3, 5)], dict(axis=1), True),
    ("quantile", "quantile", lambda: [distinct(3, 6)], dict(q=0.3, axis=1),
     True),
    ("quantile-list", "quantile", lambda: [distinct(4, 5)],
     dict(q=[0.25, 0.75], axis=0), True),
    ("count_nonzero", "count_nonzero",
     lambda: [ints(3, 5, lo=-1, hi=2)], dict(axis=1), False),
    ("nansum", "nansum", lambda: [np.array([[1.0, np.nan], [2.0, 3.0]],
                                           np.float32)], dict(axis=1), False),
    ("nansum-grad", "nansum", lambda: [f(3, 4)], {}, True),
    ("nanmean", "nanmean", lambda: [np.array([[1.0, np.nan], [2.0, 3.0]],
                                             np.float32)], dict(axis=1),
     False),
    ("nanmean-grad", "nanmean", lambda: [f(3, 4)], dict(axis=0), True),
]

MANIPULATION = [
    ("cast", "cast", lambda: [f(3, 4)], dict(dtype="int32"), False),
    ("cast-float64", "cast", lambda: [f(3, 4)], dict(dtype="float64"), True),
    ("astype", "astype", lambda: [ints(3, 4)], dict(dtype="float32"), False),
    ("reshape", "reshape", lambda: [f(3, 4)], dict(shape=[2, -1]), True),
    ("transpose", "transpose", lambda: [f(2, 3, 4)], dict(perm=[2, 0, 1]),
     True),
    ("t", "t", lambda: [f(3, 4)], {}, True),
    ("t-1d", "t", lambda: [f(4)], {}, True),
    ("flatten", "flatten", lambda: [f(2, 3, 4)], {}, True),
    ("flatten-range", "flatten", lambda: [f(2, 3, 4, 2)],
     dict(start_axis=1, stop_axis=2), True),
    ("squeeze", "squeeze", lambda: [f(2, 1, 3, 1)], {}, True),
    ("squeeze-axis-not-one", "squeeze", lambda: [f(2, 1, 3)],
     dict(axis=[0, 1]), True),
    ("unsqueeze", "unsqueeze", lambda: [f(2, 3)], dict(axis=[0, 3]), True),
    ("unsqueeze-neg", "unsqueeze", lambda: [f(2, 3)], dict(axis=-1), True),
    ("split", "split", lambda: [f(6, 4)], dict(num_or_sections=3), True),
    ("split-sections", "split", lambda: [f(6, 4)],
     dict(num_or_sections=[-1, 1], axis=1), True),
    ("chunk", "chunk", lambda: [f(4, 6)], dict(chunks=3, axis=1), True),
    ("unbind", "unbind", lambda: [f(3, 4)], dict(axis=1), True),
    ("tile", "tile", lambda: [f(2, 3)], dict(repeat_times=[2, 1, 2]), True),
    ("expand", "expand", lambda: [f(3, 1)], dict(shape=[2, 3, 4]), True),
    ("expand-keep", "expand", lambda: [f(3, 1)], dict(shape=[-1, 5]), True),
    ("broadcast_to", "broadcast_to", lambda: [f(1, 4)], dict(shape=[3, 4]),
     True),
    ("expand_as", "expand_as", lambda: [f(1, 4), f(3, 4, seed=1)], {}, True),
    ("flip", "flip", lambda: [f(3, 4)], dict(axis=[0, 1]), True),
    ("roll", "roll", lambda: [f(3, 4)], dict(shifts=1, axis=1), True),
    ("roll-flat", "roll", lambda: [f(3, 4)], dict(shifts=2), True),
    ("rot90", "rot90", lambda: [f(3, 4)], dict(k=1), True),
    ("gather", "gather", lambda: [f(5, 3), np.array([4, 0, 2, 2])], {}, True),
    ("gather-axis-2d-index", "gather",
     lambda: [f(3, 5), np.array([[4, 0], [1, 1]])], dict(axis=1), True),
    ("gather_nd", "gather_nd",
     lambda: [f(3, 4, 2), np.array([[0, 1], [2, 3], [1, 1]])], {}, True),
    ("take_along_axis", "take_along_axis",
     lambda: [f(3, 4), np.array([[0, 3], [1, 1], [2, 0]])], dict(axis=1),
     True),
    ("put_along_axis", "put_along_axis",
     lambda: [f(3, 4), np.array([[0, 3], [1, 2], [2, 0]]), f(3, 2, seed=1)],
     dict(axis=1), True),
    ("put_along_axis-add", "put_along_axis",
     lambda: [f(3, 4), np.array([[0, 0], [1, 2], [2, 0]]), f(3, 2, seed=1)],
     dict(axis=1, reduce="add"), True),
    ("put_along_axis-mean", "put_along_axis",
     lambda: [f(3, 4), np.array([[0, 0], [1, 2], [2, 0]]), f(3, 2, seed=1)],
     dict(axis=1, reduce="mean"), False),
    ("scatter", "scatter", lambda: [f(5, 3), np.array([4, 0, 2]),
                                    f(3, 3, seed=1)], {}, True),
    ("scatter-add", "scatter", lambda: [f(5, 3), np.array([4, 0, 4]),
                                        f(3, 3, seed=1)],
     dict(overwrite=False), True),
    ("scatter_nd_add", "scatter_nd_add",
     lambda: [f(3, 4), np.array([[0, 1], [2, 3], [0, 1]]), f(3, seed=1)], {},
     True),
    ("index_select", "index_select", lambda: [f(5, 3), np.array([4, 0, 4])],
     dict(axis=0), True),
    ("index_sample", "index_sample",
     lambda: [f(3, 5), np.array([[0, 4], [1, 1], [3, 2]])], {}, True),
    ("topk", "topk", lambda: [distinct(3, 6)], dict(k=2), True),
    ("topk-smallest-axis0", "topk", lambda: [distinct(5, 3)],
     dict(k=2, axis=0, largest=False), True),
    ("argsort", "argsort", lambda: [distinct(3, 5)], {}, False),
    ("argsort-desc-ties", "argsort", lambda: [ints(3, 7, lo=0, hi=3)],
     dict(descending=True), False),
    ("sort", "sort", lambda: [distinct(3, 5)], dict(axis=0), True),
    ("sort-desc", "sort", lambda: [distinct(3, 5)], dict(descending=True),
     True),
    ("unique", "unique", lambda: [ints(4, 5, lo=0, hi=6)],
     dict(return_index=True, return_inverse=True, return_counts=True),
     False),
    ("unique-plain", "unique", lambda: [ints(12, lo=0, hi=5)], {}, False),
    ("pad-full", "pad", lambda: [f(2, 3)], dict(pad=[1, 0, 2, 1], value=0.5),
     True),
    ("pad-last-dims", "pad", lambda: [f(1, 2, 3, 4)], dict(pad=[1, 2, 0, 1]),
     True),
    ("pad-reflect", "pad", lambda: [f(1, 2, 5)],
     dict(pad=[2, 1], mode="reflect"), True),
    ("repeat_interleave", "repeat_interleave", lambda: [f(3, 2)],
     dict(repeats=2, axis=0), True),
    ("repeat_interleave-flat", "repeat_interleave", lambda: [f(2, 2)],
     dict(repeats=3), True),
    ("masked_select", "masked_select", lambda: [f(3, 4), bools(3, 4)], {},
     False),
    ("masked_fill", "masked_fill", lambda: [f(3, 4), bools(3, 4)],
     dict(value=-1.5), True),
    ("nonzero", "nonzero", lambda: [bools(3, 4)], {}, False),
    ("nonzero-tuple", "nonzero", lambda: [bools(3, 4)], dict(as_tuple=True),
     False),
    ("moveaxis", "moveaxis", lambda: [f(2, 3, 4)],
     dict(source=0, destination=2), True),
    ("slice", "slice", lambda: [f(4, 5)],
     dict(axes=[0, 1], starts=[1, -3], ends=[3, 100]), True),
    ("numel", "numel", lambda: [f(3, 4)], {}, False),
    ("take", "take", lambda: [f(3, 4), np.array([0, 11, -1, 5])], {}, True),
    ("take-wrap", "take", lambda: [f(3, 4), np.array([13, -14, 2])],
     dict(mode="wrap"), True),
    ("take-clip", "take", lambda: [f(3, 4), np.array([13, -14, 2])],
     dict(mode="clip"), True),
    ("index_add", "index_add", lambda: [f(5, 3), np.array([4, 0, 4]), 0,
                                        f(3, 3, seed=1)], {}, True),
    ("index_put", "index_put",
     lambda: [f(3, 4), (np.array([0, 2]), np.array([1, 3])), f(2, seed=1)],
     {}, True),
    ("index_put-accumulate", "index_put",
     lambda: [f(3, 4), (np.array([0, 0]), np.array([1, 1])), f(2, seed=1)],
     dict(accumulate=True), True),
    ("diag_embed", "diag_embed", lambda: [f(2, 3)], dict(offset=1), True),
    ("unique_consecutive", "unique_consecutive",
     lambda: [np.array([1, 1, 2, 2, 2, 3, 1, 1])],
     dict(return_inverse=True, return_counts=True), False),
    ("bucketize", "bucketize",
     lambda: [f(3, 4), np.array([-1.0, 0.0, 0.5, 1.0], np.float32)], {},
     False),
    ("bucketize-right", "bucketize",
     lambda: [np.array([0.0, 0.5, 2.0], np.float32),
              np.array([-1.0, 0.0, 0.5, 1.0], np.float32)],
     dict(right=True), False),
    # public names beyond api.yaml
    ("concat", "concat", lambda: [[f(2, 3), f(1, 3, seed=1)]], {}, True),
    ("stack", "stack", lambda: [[f(2, 3), f(2, 3, seed=1)]], dict(axis=1),
     True),
    ("where", "where", lambda: [bools(3, 4), f(3, 4), f(3, 4, seed=1)], {},
     True),
    ("one_hot", "one_hot", lambda: [np.array([0, 2, 1])],
     dict(num_classes=4), False),
    ("diagonal", "diagonal", lambda: [f(3, 4)], dict(offset=1), True),
    ("kthvalue", "kthvalue", lambda: [distinct(3, 5)], dict(k=2), True),
    ("searchsorted", "searchsorted",
     lambda: [np.array([-1.0, 0.0, 0.5, 1.0], np.float32), f(5)], {}, False),
    ("strided_slice", "strided_slice", lambda: [f(6, 5)],
     dict(axes=[0, 1], starts=[0, 1], ends=[6, 5], strides=[2, 2]), True),
    ("unstack", "unstack", lambda: [f(3, 2)], dict(axis=0), True),
    ("crop", "crop", lambda: [f(4, 5)], dict(shape=[2, -1],
                                              offsets=[1, 2]), True),
    ("reverse", "reverse", lambda: [f(3, 4)], dict(axis=0), True),
    ("broadcast_tensors", "broadcast_tensors",
     lambda: [[f(3, 1), f(1, 4, seed=1)]], {}, True),
    ("mode", "mode", lambda: [np.array([[1, 2, 2, 3], [4, 4, 1, 1]])], {},
     False),
    ("shard_index", "shard_index", lambda: [np.array([[1], [7], [12]])],
     dict(index_num=16, nshards=2, shard_id=0), False),
    ("scatter_nd", "scatter_nd",
     lambda: [np.array([[0, 1], [2, 0]]), f(2, seed=1)],
     dict(shape=[3, 2]), True),
]

LINALG = [
    ("matmul", "matmul", lambda: [f(2, 3, 4), f(2, 4, 5, seed=1)], {}, True),
    ("matmul-transposed", "matmul", lambda: [f(4, 3), f(5, 4, seed=1)],
     dict(transpose_x=True, transpose_y=True), True),
    ("matmul-vector", "matmul", lambda: [f(3, 4), f(4, seed=1)], {}, True),
    ("bmm", "bmm", lambda: [f(2, 3, 4), f(2, 4, 5, seed=1)], {}, True),
    ("mm", "mm", lambda: [f(3, 4), f(4, 2, seed=1)], {}, True),
]

CREATION = [
    ("to_tensor-ints", "to_tensor", lambda: [[[1, 2], [3, 4]]], {}, False),
    ("to_tensor-floats", "to_tensor", lambda: [[1.5, 2.5]], {}, False),
    ("to_tensor-array", "to_tensor", lambda: [f(2, 3)], {}, False),
    ("to_tensor-dtype", "to_tensor", lambda: [[1, 2]],
     dict(dtype="float32"), False),
    ("full", "full", lambda: [[2, 3], 1.5], {}, False),
    ("full-int", "full", lambda: [[2, 3], 4], {}, False),
    ("full-bool", "full", lambda: [[2], True], {}, False),
    ("zeros", "zeros", lambda: [[2, 3]], {}, False),
    ("ones-int", "ones", lambda: [[2, 3]], dict(dtype="int64"), False),
    ("full_like", "full_like", lambda: [f(2, 3), 7.0], {}, False),
    ("zeros_like", "zeros_like", lambda: [ints(2, 3)], {}, False),
    ("ones_like", "ones_like", lambda: [f(2, 3)], dict(dtype="int32"), False),
    ("arange", "arange", lambda: [5], {}, False),
    ("arange-step", "arange", lambda: [1, 10, 3], {}, False),
    ("arange-float", "arange", lambda: [0.0, 1.0, 0.25], {}, False),
    ("linspace", "linspace", lambda: [0.0, 1.0, 5], {}, False),
    ("eye", "eye", lambda: [3], dict(num_columns=4), False),
    ("empty", "empty", lambda: [[2, 3]], {}, False),
    ("empty_like", "empty_like", lambda: [f(2, 3)], {}, False),
    ("tril", "tril", lambda: [f(3, 4)], dict(diagonal=1), True),
    ("triu", "triu", lambda: [f(3, 4)], dict(diagonal=-1), True),
    ("diag-vector", "diag", lambda: [f(3)], dict(offset=1), True),
    ("diag-padding", "diag", lambda: [f(3)], dict(padding_value=2.0), True),
    ("diag-matrix", "diag", lambda: [f(3, 4)], {}, True),
    ("diagflat", "diagflat", lambda: [f(2, 2)], dict(offset=-1), True),
    ("meshgrid", "meshgrid", lambda: [f(3), f(2, seed=1)], {}, True),
    ("assign", "assign", lambda: [f(3, 4)], {}, True),
    ("clone", "clone", lambda: [f(3, 4)], {}, True),
    ("tril_indices", "tril_indices", lambda: [4, 3, 1], {}, False),
    ("triu_indices", "triu_indices", lambda: [3, 4, -1], {}, False),
    ("complex", "complex", lambda: [f(3), f(3, seed=1)], {}, False),
]

CASES = [pytest.param(*c[1:], id=c[0]) for c in
         MATH + COMPARISON + REDUCTION + MANIPULATION + LINALG + CREATION]


@pytest.mark.parametrize("name,make,kwargs,diff", CASES)
def test_op_matches_jax(name, make, kwargs, diff):
    run_case(name, make, kwargs, diff)


def _api_yaml_names():
    import pathlib

    import yaml

    path = pathlib.Path(J.__file__).parent / "ops" / "api.yaml"
    methods = yaml.safe_load(path.read_text())["methods"]
    return {g: list(methods[g]) for g in
            ("math", "reduction", "manipulation", "comparison")}


@pytest.mark.parametrize("group", ["math", "reduction", "manipulation",
                                   "comparison", "creation"])
def test_every_name_is_exported_and_has_a_case(group):
    """Every name of ``api.yaml``'s four method groups and every public
    function of the JAX ``ops/creation.py`` is at the port's top level and
    held against the JAX package by a case above."""
    if group == "creation":
        from paddle_tpu.ops import creation as jc

        names = [n for n in dir(jc) if not n.startswith("_") and
                 callable(getattr(jc, n)) and
                 getattr(getattr(jc, n), "__module__", "") == jc.__name__]
    else:
        names = _api_yaml_names()[group]
    covered = {c[1] for c in MATH + COMPARISON + REDUCTION + MANIPULATION +
               LINALG + CREATION} | set(RANDOM)
    missing = [n for n in names if not callable(getattr(P, n, None))]
    assert not missing, missing
    untested = [n for n in names if n not in covered]
    assert not untested, untested


# -- random creation: shapes, dtypes, ranges ---------------------------------

def _rand_checks():
    def rand_():
        t = P.rand([3, 4])
        assert t.dtype == torch.float32 and t.shape == (3, 4)
        assert 0.0 <= float(t.min()) and float(t.max()) < 1.0

    def uniform_():
        t = P.uniform([1000], min=-2.0, max=3.0)
        assert -2.0 <= float(t.min()) and float(t.max()) < 3.0
        a = P.uniform([4], seed=5)
        b = P.uniform([4], seed=5)
        assert torch.equal(a, b)

    def normal_():
        t = P.normal(1.0, 2.0, shape=[20000])
        assert abs(float(t.mean()) - 1.0) < 0.1
        assert abs(float(t.std()) - 2.0) < 0.1

    def randn_():
        t = P.randn([2, 3], dtype="float64")
        assert t.dtype == torch.float64 and t.shape == (2, 3)

    def standard_normal_():
        t = P.standard_normal([20000])
        assert abs(float(t.std()) - 1.0) < 0.05

    def randint_():
        t = P.randint(2, 7, [500])
        assert t.dtype == torch.int64
        assert int(t.min()) >= 2 and int(t.max()) <= 6

    def randperm_():
        t = P.randperm(10)
        assert sorted(t.tolist()) == list(range(10)) and t.dtype == torch.int64

    def bernoulli_():
        t = P.bernoulli(P.full([1000], 0.3))
        assert set(t.unique().tolist()) <= {0.0, 1.0}
        assert 0.2 < float(t.mean()) < 0.4

    def multinomial_():
        probs = P.to_tensor([[0.0, 1.0, 0.0], [0.5, 0.0, 0.5]])
        t = P.multinomial(probs, 2, replacement=True)
        assert t.shape == (2, 2) and set(t[0].tolist()) == {1}
        assert set(t[1].tolist()) <= {0, 2}

    def randint_like_():
        x = P.zeros([3, 2], dtype="int32")
        t = P.randint_like(x, 0, 3)
        assert t.shape == (3, 2) and t.dtype == torch.int32
        assert int(t.max()) < 3

    def poisson_():
        t = P.poisson(P.full([2000], 4.0))
        assert float(t.min()) >= 0 and torch.equal(t, t.round())
        assert 3.7 < float(t.mean()) < 4.3

    def create_parameter_():
        w = P.create_parameter([16, 4], "float32")
        bound = (6.0 / 16) ** 0.5
        assert float(w.detach().abs().max()) <= bound and w.requires_grad
        b = P.create_parameter([4], "float32", is_bias=True)
        assert float(b.detach().abs().max()) == 0.0
        j = J.create_parameter([16, 4], "float32")
        assert list(j.shape) == list(w.shape)
        assert float(np.abs(j.numpy()).max()) <= bound

    return {k[:-1]: v for k, v in locals().items()}


RANDOM = _rand_checks()


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_creation(name):
    P.seed(0)
    RANDOM[name]()


def test_seed_reproduces_and_returns_the_default_generator():
    g = P.seed(11)
    assert g is torch.default_generator
    a = P.rand([5])
    P.seed(11)
    assert torch.equal(a, P.rand([5]))
    state = P.get_rng_state()
    b = P.randn([3])
    P.set_rng_state(state)
    assert torch.equal(b, P.randn([3]))


def test_grad_follows_paddle():
    """``grad`` leaves ``.grad`` alone and raises on an unused input
    unless ``allow_unused``."""
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    y = P.to_tensor([3.0], stop_gradient=False)
    x.grad = torch.tensor([9.0, 9.0])
    (g,) = P.grad(P.sum(x * x), x)
    assert g.tolist() == [2.0, 4.0] and x.grad.tolist() == [9.0, 9.0]
    with pytest.raises(RuntimeError, match="unused"):
        P.grad(P.sum(x * x), [x, y])
    gx, gy = P.grad(P.sum(x * x), [x, y], allow_unused=True)
    assert gy is None and gx.tolist() == [2.0, 4.0]
    with P.no_grad():
        assert not P.is_grad_enabled()
        assert not (x * 2).requires_grad
    assert P.Tensor is torch.Tensor


def test_dtypes_places_and_infos():
    assert P.float32 is torch.float32 and P.bool is torch.bool
    assert P.iinfo("int64").max == 2 ** 63 - 1
    assert P.finfo("bfloat16").eps == J.finfo("bfloat16").eps
    assert P.finfo("float32").tiny == J.finfo("float32").tiny
    assert P.get_default_dtype() == torch.float32
    P.set_default_dtype("float64")
    try:
        assert P.to_tensor([1.5]).dtype == torch.float64
        assert P.zeros([2]).dtype == torch.float64
    finally:
        P.set_default_dtype("float32")
    with pytest.raises(TypeError):
        P.set_default_dtype("int32")
    assert P.get_device() == "cpu"
    assert P.CPUPlace().device == torch.device("cpu")
    with pytest.raises(ValueError, match="CUDAPlace"):
        P.TPUPlace(0)
    with pytest.raises(ValueError, match="CUDAPlace"):
        P.set_device("tpu")


def test_flags_hold_the_oov_policy_and_refuse_unknown_names():
    assert P.get_flags("embedding_oov_policy") == {
        "FLAGS_embedding_oov_policy": "error"}
    with pytest.raises(ValueError, match="unknown flag"):
        P.set_flags({"FLAGS_no_such_flag": 1})
    with pytest.raises(ValueError, match="must be one of"):
        P.set_flags({"FLAGS_embedding_oov_policy": "wrap"})
    with pytest.raises(ValueError, match="unknown flag"):
        J.set_flags({"FLAGS_no_such_flag": 1})


def test_take_raise_mode_checks_the_ids():
    x = P.arange(6)
    with pytest.raises(IndexError, match="out of range"):
        P.take(x, P.to_tensor([6]))
