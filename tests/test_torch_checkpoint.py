"""The port's sharded checkpoints (``distributed.checkpoint``) against the
JAX package's module: the on-disk format read both ways (fp32, int and
bf16, whose raw 16-bit words the port writes and reads without
``ml_dtypes``), the sha256 check, strict loads, and a model with its AdamW
state resumed in one process bit for bit. Saving at one mesh and loading
at others runs in ``test_torch_pipeline.py``'s gloo world."""
import io
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import checkpoint as ckpt


def _jax_ckpt():
    import paddle_tpu.distributed.checkpoint as jckpt

    return jckpt


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(5, 7, generator=g),
            "b16": torch.randn(3, 4, 6, generator=g).to(torch.bfloat16),
            "ids": torch.arange(12, dtype=torch.int64).reshape(3, 4),
            "scalar": torch.tensor(2.5)}


def test_bf16_npy_bytes_equal_what_ml_dtypes_writes():
    """A bf16 tensor's ``.npy`` bytes are those ``np.save`` writes for the
    same ``ml_dtypes.bfloat16`` array (descr ``<V2``, the raw words)."""
    import ml_dtypes

    t = _tensors()["b16"]
    mine = io.BytesIO()
    ckpt._npy_bytes(t, mine)
    theirs = io.BytesIO()
    np.save(theirs, t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    assert mine.getvalue() == theirs.getvalue()


def test_jax_module_reads_what_the_port_wrote(tmp_path):
    """The port saves; the JAX module's manifest reader and assembler read
    every entry back equal (bf16 through ``ml_dtypes``)."""
    jckpt = _jax_ckpt()
    ts = _tensors()
    ckpt.save_state_dict(ts, str(tmp_path))
    entries = jckpt.load_manifest(str(tmp_path))["entries"]
    assert set(entries) == set(ts)
    for k, t in ts.items():
        arr = jckpt._assemble(str(tmp_path), entries[k])
        assert entries[k]["dtype"] == str(arr.dtype)
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(arr.astype(np.float32),
                                          t.float().numpy())
        else:
            np.testing.assert_array_equal(arr, t.numpy())


def test_port_reads_what_the_jax_module_wrote(tmp_path):
    """The JAX module saves (bf16 through ``ml_dtypes``); the port's
    ``load_state_dict`` fills its tensors equal, and a non-tensor value
    becomes the whole array."""
    import jax.numpy as jnp

    jckpt = _jax_ckpt()
    ts = _tensors()
    jckpt.save_state_dict({
        "w": jnp.asarray(ts["w"].numpy()),
        "b16": jnp.asarray(ts["b16"].float().numpy(), dtype=jnp.bfloat16),
        "ids": np.asarray(ts["ids"].numpy()),
        "scalar": np.asarray(2.5, np.float32)}, str(tmp_path),
        process_rank=0)
    got = {k: torch.zeros_like(t) for k, t in ts.items() if k != "scalar"}
    got["scalar"] = None
    ckpt.load_state_dict(got, str(tmp_path))
    for k in ("w", "b16", "ids"):
        assert torch.equal(got[k], ts[k]), k
    assert float(got["scalar"]) == 2.5


def test_corrupt_shard_raises_and_strict_names_missing_keys(tmp_path):
    """A byte flipped in a saved shard raises ``CheckpointCorrupt`` (and
    loads with ``verify=False``); a key the checkpoint lacks raises under
    ``strict`` and is left alone otherwise."""
    ts = _tensors()
    ckpt.save_state_dict(ts, str(tmp_path))
    entry = ckpt.load_manifest(str(tmp_path))["entries"]["w"]
    path = os.path.join(str(tmp_path), entry["shards"][0]["file"])
    raw = bytearray(open(path, "rb").read())
    raw[-3] ^= 0x01
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.load_state_dict({"w": torch.zeros(5, 7)}, str(tmp_path))
    ckpt.load_state_dict({"w": torch.zeros(5, 7)}, str(tmp_path),
                         verify=False)
    with pytest.raises(ValueError, match="missing keys"):
        ckpt.load_state_dict({"nope": torch.zeros(2)}, str(tmp_path))
    kept = torch.ones(2)
    ckpt.load_state_dict({"nope": kept}, str(tmp_path), strict=False)
    assert torch.equal(kept, torch.ones(2))


def test_splits_reassemble_and_reslice():
    """A tensor saved as shards (mp outer, sdp inner on the same dim)
    reassembles whole, and slices for another split."""
    full = torch.arange(48.0).reshape(8, 6)
    deg = {"mp": 2, "sdp": 2}
    pieces = []
    for m in range(2):
        for z in range(2):
            c = {"mp": m, "sdp": z}
            local = ckpt._local_slice(full, [(0, "mp"), (0, "sdp")], c, deg)
            gshape, starts = ckpt._layout(tuple(local.shape),
                                          [(0, "mp"), (0, "sdp")], c, deg)
            assert gshape == [8, 6]
            pieces.append((starts, local))
    out = torch.zeros(8, 6)
    for starts, local in pieces:
        out[starts[0]:starts[0] + local.shape[0]] = local
    assert torch.equal(out, full)
    assert torch.equal(ckpt._local_slice(full, [(1, "mp")], {"mp": 1},
                                         {"mp": 2}), full[:, 3:])


def test_model_and_adamw_resume_bit_for_bit(tmp_path):
    """The tiny Llama and its AdamW state saved after one step, loaded
    into a fresh model and optimizer: the next two steps equal the
    unbroken run's bit for bit, the step count restored."""
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    ids = torch.randint(0, 256, (2, 16),
                        generator=torch.Generator().manual_seed(1))

    def loss_fn(m, x, y):
        return m(x, labels=y)

    model = LlamaForCausalLM(cfg, device="cpu", generator=seed(4, "cpu"))
    opt = AdamW(learning_rate=1e-3, parameters=model.named_parameters())
    step = TrainStep(model, loss_fn, opt)
    step(ids, ids)
    ckpt.save_sharded_model(model, opt, str(tmp_path))
    want = [float(step(ids, ids)) for _ in range(2)]
    fresh = LlamaForCausalLM(cfg, device="cpu", generator=seed(9, "cpu"))
    fopt = AdamW(learning_rate=1e-3, parameters=fresh.named_parameters())
    ckpt.load_sharded_model(fresh, fopt, str(tmp_path))
    assert fopt._global_step == 1
    fstep = TrainStep(fresh, loss_fn, fopt)
    assert [float(fstep(ids, ids)) for _ in range(2)] == want
    for (n, p), (_, q) in zip(model.named_parameters(),
                              fresh.named_parameters()):
        assert torch.equal(p, q), n
    names = set(ckpt.load_manifest(str(tmp_path))["entries"])
    assert "opt.global_step" in names
    assert "opt.llama.norm.weight.moment2" in names
