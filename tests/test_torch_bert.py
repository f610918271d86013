"""The port's BERT against the JAX package's, on the paddle surface.

``BertConfig.tiny()`` (2 layers, hidden 64, 4 heads, vocab 256) in fp32:
weights drawn with numpy from a seed, set into the JAX model and carried
across by ``bert_state_from_numpy`` into the port's model (on the CPU,
``set_device("cpu")``; attention there is the flash kernels' plain version
without a mask and the JAX ``_sdpa_xla`` composition with one). Compared
within 1e-4 (the fp32 tolerance of the port's kernels): classification
logits with and without ``attention_mask``, ``BertForPretraining``'s MLM +
NSP loss (MLM labels of -100 ignored, the decoder tied to the word
embeddings) and every parameter's gradient, and three ``TrainStep``
steps of the finetune recipe (AdamW + ``ClipGradByGlobalNorm(1.0)``,
``CrossEntropyLoss``; the rate raised from 2e-5 to 2e-3 so that three
steps move the weights well past the tolerance) against the JAX
``jit.TrainStep``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu import jit as jjit
from paddle_tpu.models import bert as jbert
import paddle_tpu_torch as P
import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     BertForSequenceClassification,
                                     bert_param_count, bert_state_from_numpy)

TOL = 1e-4
LR = 2e-3
_MP = ("qkv", "attn_out", "ffn_in", "ffn_out")


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


def _is_mp_weight(name):
    parts = name.split(".")
    return name.endswith(".weight") and len(parts) > 2 and parts[-2] in _MP


def make_pair(jcls, pcls, seed=0, **kw):
    """A JAX model and the port's holding the same numpy-drawn weights."""
    J.seed(seed)
    jm = jcls(jbert.BertConfig.tiny(), **kw)
    rng = np.random.default_rng(seed)
    state = {}
    for name, v in jm.state_dict().items():
        shape = tuple(v.shape)
        if "norm" in name and name.endswith("weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith("bias"):
            a = 0.1 * rng.standard_normal(shape)
        else:
            a = 0.2 * rng.standard_normal(shape)
        state[name] = a.astype(np.float32)
    jm.set_state_dict(state)
    pm = pcls(BertConfig.tiny(), **kw)
    missing, unexpected = pm.set_state_dict(bert_state_from_numpy(state))
    assert not missing and not unexpected
    return jm, pm


def _batch(seed=1, b=3, s=12, vocab=256):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int64)
    mask = np.ones((b, s), np.int64)
    mask[0, 8:] = 0
    mask[2, 5:] = 0
    types = (np.arange(s)[None, :] >= s // 2).astype(np.int64).repeat(b, 0)
    return ids, mask, types


def _port_layout(name, a):
    return a.T if _is_mp_weight(name) else a


def test_state_names_shapes_and_param_count():
    jm, pm = make_pair(jbert.BertForPretraining, BertForPretraining)
    jsd, psd = jm.state_dict(), pm.state_dict()
    assert sorted(jsd) == sorted(psd)
    for k, v in jsd.items():
        assert _port_layout(k, np.zeros(tuple(v.shape))).shape == \
            tuple(psd[k].shape), k
    cls = BertForSequenceClassification(BertConfig.tiny())
    assert sum(p.numel() for p in cls.parameters()) == \
        bert_param_count(BertConfig.tiny())[0]
    total, body = bert_param_count(BertConfig())
    assert total == 109483778 and body == 85648130


@pytest.mark.parametrize("masked", [False, True])
def test_classification_logits_match_jax(masked):
    jm, pm = make_pair(jbert.BertForSequenceClassification,
                       BertForSequenceClassification, num_classes=3)
    ids, mask, types = _batch()
    jm.eval()
    pm.eval()
    jkw = dict(token_type_ids=J.to_tensor(types))
    pkw = dict(token_type_ids=torch.from_numpy(types))
    if masked:
        jkw["attention_mask"] = J.to_tensor(mask)
        pkw["attention_mask"] = torch.from_numpy(mask)
    ref = np.asarray(jm(J.to_tensor(ids), **jkw).numpy())
    with torch.no_grad():
        got = pm(torch.from_numpy(ids), **pkw).numpy()
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_pretraining_loss_and_gradients_match_jax(masked):
    jm, pm = make_pair(jbert.BertForPretraining, BertForPretraining)
    ids, mask, types = _batch(seed=2)
    rng = np.random.default_rng(3)
    mlm = np.where(rng.random(ids.shape) < 0.3, ids, -100).astype(np.int64)
    nsp = rng.integers(0, 2, (ids.shape[0],)).astype(np.int64)
    jkw = dict(token_type_ids=J.to_tensor(types),
               masked_lm_labels=J.to_tensor(mlm),
               next_sentence_labels=J.to_tensor(nsp))
    pkw = dict(token_type_ids=torch.from_numpy(types),
               masked_lm_labels=torch.from_numpy(mlm),
               next_sentence_labels=torch.from_numpy(nsp))
    if masked:
        jkw["attention_mask"] = J.to_tensor(mask)
        pkw["attention_mask"] = torch.from_numpy(mask)
    jloss = jm(J.to_tensor(ids), **jkw)
    ploss = pm(torch.from_numpy(ids), **pkw)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=TOL)
    jloss.backward()
    ploss.backward()
    jp = dict(jm.named_parameters())
    for name, p in pm.named_parameters():
        jg = np.asarray(jp[name].grad.numpy())
        np.testing.assert_allclose(p.grad.numpy(), _port_layout(name, jg),
                                   rtol=TOL, atol=TOL, err_msg=name)
    # the MLM decoder is the word table: its gradient has both uses
    assert float(pm.bert.embeddings.word_embeddings.weight.grad.abs()
                 .sum()) > 0


@pytest.mark.parametrize("masked", [False, True])
def test_finetune_steps_match_jax(masked):
    """Three steps of the finetune recipe: losses and every parameter
    within 1e-4 of the JAX ``jit.TrainStep``'s."""
    jm, pm = make_pair(jbert.BertForSequenceClassification,
                       BertForSequenceClassification)
    ids, mask, _ = _batch(seed=4, b=4)
    labels = np.array([0, 1, 1, 0], np.int64)

    def recipe(opt_mod, nn_mod, model):
        loss_fn = nn_mod.CrossEntropyLoss()
        opt = opt_mod.AdamW(learning_rate=LR,
                            parameters=model.parameters(),
                            grad_clip=nn_mod.ClipGradByGlobalNorm(1.0))
        if masked:
            return (lambda m, x, am, y: loss_fn(m(x, attention_mask=am), y)), \
                opt
        return (lambda m, x, y: loss_fn(m(x), y)), opt

    jfn, jo = recipe(jopt, jnn, jm)
    pfn, po = recipe(popt, pnn, pm)
    jstep, pstep = jjit.TrainStep(jm, jfn, jo), TrainStep(pm, pfn, po)
    jargs = [J.to_tensor(ids)] + ([J.to_tensor(mask)] if masked else []) + \
        [J.to_tensor(labels)]
    pargs = [torch.from_numpy(ids)] + \
        ([torch.from_numpy(mask)] if masked else []) + \
        [torch.from_numpy(labels)]
    ref = [float(jstep(*jargs)) for _ in range(3)]
    got = [float(pstep(*pargs)) for _ in range(3)]
    np.testing.assert_allclose(got, ref, rtol=TOL)
    assert ref[-1] < ref[0]
    jsd = dict(jm.named_parameters())
    for name, p in pm.named_parameters():
        a = p.detach().numpy()
        b = _port_layout(name, np.asarray(jsd[name].numpy()))
        if name.endswith("qkv.bias"):
            # The key bias adds q.b_k to a whole row of logits, which the
            # softmax cancels: its gradient is 0 in exact arithmetic and
            # rounding noise in either package, which Adam's m / sqrt(v)
            # turns into steps of up to lr each. Its third is held to that
            # (3 steps of 2e-3); the query and value thirds to 1e-4.
            h = a.shape[0] // 3
            np.testing.assert_allclose(a[h:2 * h], b[h:2 * h], atol=3 * LR)
            a = np.concatenate([a[:h], a[2 * h:]])
            b = np.concatenate([b[:h], b[2 * h:]])
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=name)


def test_dtype_config_and_recompute():
    """``dtype="bfloat16"`` casts the model as the JAX one does;
    ``use_recompute`` gives the same loss and gradients as without."""
    m = BertForSequenceClassification(BertConfig.tiny(dtype="bfloat16"))
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    ids, _, _ = _batch(seed=5)
    y = torch.tensor([0, 1, 0])
    out = []
    for recompute in (False, True):
        P.seed(9)
        model = BertForSequenceClassification(BertConfig.tiny(
            use_recompute=recompute, hidden_dropout_prob=0.1,
            attention_probs_dropout_prob=0.1))
        P.seed(10)
        loss = model(torch.from_numpy(ids), labels=y)
        loss.backward()
        out.append((float(loss), [p.grad.clone() for p in
                                  model.parameters()]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
