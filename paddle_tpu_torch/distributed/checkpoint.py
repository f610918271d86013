"""Sharded checkpoints that reshard on load (port of
``paddle_tpu/distributed/checkpoint.py``).

The on-disk format is the JAX package's, so either package reads what the
other wrote: a directory with one ``.npy`` file per saved shard and one
JSON manifest fragment per rank (``manifest.r{rank}.json``, format 2:
each entry's global shape, dtype name, split spec and its shards' files,
start and stop offsets and sha256). Every file lands through a temporary
file, ``fsync`` and ``os.replace``, the manifest fragment last (the
commit point of the rank's save).

Each rank writes only the shards it owns, replica 0 of each: a tensor's
split is read from the attributes the port's layers put on it (``ep_dim``,
over ep; ``mp_dim``, over mp, in ``mp_blocks`` blocks where the dim is
made of blocks each split over mp, as GPT's fused q/k/v rows are: a shard
a block; ``zero3_dim`` / ``zero_dim``, over sdp inside the mp shard), and
a rank writes a shard where its coordinate on every other axis but pp is
0 (a pipeline stage's tensors live on that stage alone). A weight tied
across pipeline stages is saved once, under the name its first holder
gives it (the one name a model at pp = 1 holds it under): a later stage's
copy carries ``ckpt_name`` and ``ckpt_copy`` and loads from that entry.
A load
reassembles each tensor from whatever split it was saved with and slices
it for the target's split on the current mesh: a checkpoint saved at dp 2
x mp 2 loads at pp 2 x dp 2, at sdp 4 or in one process.

bf16 is stored as the JAX package stores it through ``ml_dtypes``: the
array's raw 16-bit words under the numpy descr ``<V2`` and the manifest
dtype name ``bfloat16``; the port writes and reads those bytes directly,
with no ``ml_dtypes``.
"""
from __future__ import annotations

import glob
import hashlib
import io
import json
import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import MESH_ORDER, get_mesh_env
from .meta_parallel.mp_layers import mp_shard

__all__ = ["CheckpointCorrupt", "save_state_dict", "load_state_dict",
           "load_manifest", "save_sharded_model", "load_sharded_model",
           "tensor_splits"]


class CheckpointCorrupt(RuntimeError):
    """A saved file does not match its manifest checksum (a torn save, bit
    rot, or a partly overwritten directory)."""


_NP_DTYPES = {torch.float32: "float32", torch.float64: "float64",
              torch.float16: "float16", torch.bfloat16: "bfloat16",
              torch.int64: "int64", torch.int32: "int32",
              torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8",
              torch.bool: "bool"}


def _sanitize(key: str) -> str:
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", key)
    if safe != key:  # keys that collide after the substitution stay apart
        safe += "-" + hashlib.sha1(key.encode()).hexdigest()[:8]
    return safe


class _HashingWriter:
    """A file wrapper that hashes every byte as it is written."""

    def __init__(self, f):
        self._f = f
        self._h = hashlib.sha256()

    def write(self, b):
        self._h.update(b)
        return self._f.write(b)

    def hexdigest(self) -> str:
        return self._h.hexdigest()


def _npy_bytes(t: torch.Tensor, out) -> None:
    """Writes ``t`` (on the CPU, contiguous) as an ``.npy`` file to ``out``:
    bf16 as raw words under the descr ``<V2`` (what ``np.save`` writes for
    an ``ml_dtypes.bfloat16`` array), other dtypes as numpy writes them."""
    if t.dtype == torch.bfloat16:
        words = t.view(torch.int16).numpy()
        np.lib.format.write_array_header_1_0(
            out, {"descr": "<V2", "fortran_order": False,
                  "shape": tuple(t.shape)})
        out.write(words.tobytes())
    else:
        np.save(out, t.numpy())


def _atomic_npy(path: str, t: torch.Tensor) -> str:
    """``path`` written through a temporary file, ``fsync`` and
    ``os.replace``; returns the sha256 of its bytes."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        hw = _HashingWriter(f)
        _npy_bytes(t, hw)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return hw.hexdigest()


def _coords():
    env = get_mesh_env()
    if env is None:
        return {ax: 0 for ax in MESH_ORDER}, {ax: 1 for ax in MESH_ORDER}
    return ({ax: env.coord(ax) for ax in MESH_ORDER},
            {ax: env.get_dim(ax) for ax in MESH_ORDER})


def tensor_splits(t) -> List[tuple]:
    """``[(dim, axis), ...]``, outermost first: how the port splits ``t``
    over the mesh, from its attributes (``ep_dim``: an MoE layer's expert
    shard; ``mp_dim``: the tensor-parallel shard; ``zero3_dim`` or
    ``zero_dim``: the ZeRO slice over sdp, inside the mp shard;
    ``ckpt_splits`` given outright)."""
    given = getattr(t, "ckpt_splits", None)
    if given is not None:
        return list(given)
    out = []
    if getattr(t, "ep_dim", None) is not None:
        out.append((t.ep_dim, "ep"))
    if getattr(t, "mp_dim", None) is not None:
        out.append((t.mp_dim, "mp"))
    for attr in ("zero3_dim", "zero_dim"):
        if getattr(t, attr, None) is not None:
            out.append((getattr(t, attr), "sdp"))
            break
    return out


def _layout(shape, splits, coords, degrees):
    """(global shape, this rank's starts) of a local tensor of ``shape``."""
    gshape = list(shape)
    starts = [0] * len(shape)
    for dim, ax in reversed(splits):  # inner splits first
        starts[dim] += coords[ax] * gshape[dim]
        gshape[dim] *= degrees[ax]
    return gshape, starts


def _spec(ndim, splits):
    spec: List[object] = [None] * ndim
    for dim, ax in splits:
        spec[dim] = ax if spec[dim] is None else \
            (list(spec[dim]) if isinstance(spec[dim], list)
             else [spec[dim]]) + [ax]
    return spec


def _rank():
    return dist.get_rank() if dist.is_initialized() else 0


def save_state_dict(state_dict: Dict, path: str,
                    process_rank: Optional[int] = None) -> None:
    """Writes this rank's part of a sharded checkpoint under ``path``.
    ``state_dict``: name -> tensor (split as :func:`tensor_splits` reads
    it; a tensor without a split is whole) or numpy array / number
    (whole). A rank writes each tensor's shard where it is replica 0 of
    it (its coordinate 0 on every axis but pp and the splitting ones)."""
    os.makedirs(path, exist_ok=True)
    rank = _rank() if process_rank is None else int(process_rank)
    coords, degrees = _coords()
    manifest = {"format": 2, "entries": {}}
    for key, val in state_dict.items():
        if isinstance(val, torch.Tensor):
            if getattr(val, "ckpt_copy", False):
                continue  # a tied copy: its first holder writes it
            splits = tensor_splits(val)
            t = val.detach()
        else:
            splits = []
            t = torch.as_tensor(np.asarray(val))
        split_axes = {ax for _, ax in splits}
        if any(coords[ax] != 0 for ax in MESH_ORDER
               if ax != "pp" and ax not in split_axes):
            continue  # another replica writes it
        if t.dtype not in _NP_DTYPES:
            raise TypeError(f"{key}: dtype {t.dtype} cannot be saved")
        gshape, starts = _layout(tuple(t.shape), splits, coords, degrees)
        pieces = [(starts, t)]
        blocks = _blocks(val, splits, degrees)
        if blocks > 1:  # one shard a block
            dim = next(d for d, ax in splits if ax == "mp")
            if any(d == dim for d, ax in splits if ax != "mp"):
                raise NotImplementedError(
                    f"{key}: a blocked mp split shares its dim with another "
                    f"axis' split; save it without that split")
            per = t.shape[dim] // blocks
            pieces = []
            for b in range(blocks):
                st = list(starts)
                st[dim] = b * per * degrees["mp"] + coords["mp"] * per
                pieces.append((st, t.narrow(dim, b * per, per)))
        shards = []
        for i, (st, piece) in enumerate(pieces):
            fname = f"{_sanitize(key)}.r{rank}.s{i}.npy"
            sha = _atomic_npy(os.path.join(path, fname),
                              piece.to("cpu").contiguous())
            shards.append({"file": fname, "starts": st,
                           "stops": [a + int(d) for a, d in
                                     zip(st, piece.shape)],
                           "sha256": sha})
        manifest["entries"][key] = {
            "global_shape": [int(d) for d in gshape],
            "dtype": _NP_DTYPES[t.dtype],
            "spec": _spec(t.dim(), splits),
            "shards": shards}
    frag = os.path.join(path, f"manifest.r{rank}.json")
    tmp = f"{frag}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, frag)


def _read_shard(path: str, sh: dict, verify: bool) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    want = sh.get("sha256")
    if verify and want and hashlib.sha256(raw).hexdigest() != want:
        raise CheckpointCorrupt(
            f"shard {sh['file']} fails its manifest checksum (torn or "
            f"partially-overwritten save); restore from an older checkpoint")
    return np.load(io.BytesIO(raw))


def _assemble(path: str, entry: dict, verify: bool = True) -> torch.Tensor:
    """The whole tensor of a manifest entry from its shards (bf16 from its
    raw words)."""
    shape = tuple(entry["global_shape"])
    name = entry["dtype"]
    bf16 = name == "bfloat16"
    out = np.empty(shape, dtype=np.int16 if bf16 else np.dtype(name))
    filled = np.zeros(shape, dtype=bool) if shape else None
    for sh in entry["shards"]:
        data = _read_shard(os.path.join(path, sh["file"]), sh, verify)
        if bf16:
            if data.dtype.itemsize != 2:
                raise ValueError(f"shard {sh['file']}: {data.dtype} is not "
                                 f"16-bit words")
            data = data.view(np.int16)
        elif data.dtype != out.dtype:
            raise ValueError(f"shard {sh['file']} dtype {data.dtype} does "
                             f"not match manifest dtype {out.dtype}")
        idx = tuple(slice(a, b) for a, b in zip(sh["starts"], sh["stops"]))
        out[idx] = data
        if filled is not None:
            filled[idx] = True
    if filled is not None and not filled.all():
        raise RuntimeError("checkpoint is missing shards for part of the "
                           "tensor (every rank's save must be in the "
                           "directory)")
    t = torch.from_numpy(out)
    return t.view(torch.bfloat16) if bf16 else t


def _read_manifest(path: str) -> dict:
    frags = sorted(glob.glob(os.path.join(path, "manifest.r*.json")))
    if not frags:
        raise FileNotFoundError(f"no manifest.r*.json under {path}")
    entries: dict = {}
    for fp in frags:
        with open(fp) as f:
            m = json.load(f)
        for key, entry in m["entries"].items():
            if key in entries:
                entries[key]["shards"].extend(entry["shards"])
            else:
                entries[key] = entry
    return entries


def load_manifest(path: str) -> dict:
    return {"entries": _read_manifest(path)}


def _blocks(t, splits, degrees) -> int:
    """The blocks of ``t``'s mp split (``mp_blocks``), 1 at mp 1."""
    if degrees.get("mp", 1) <= 1 or not any(ax == "mp" for _, ax in splits):
        return 1
    return int(getattr(t, "mp_blocks", 1) or 1)


def _local_slice(full: torch.Tensor, splits, coords, degrees, blocks=1):
    for dim, ax in splits:  # outer split first
        n = degrees[ax]
        if n > 1:
            full = mp_shard(full, n, coords[ax], dim,
                            blocks if ax == "mp" else 1)
    return full


def load_state_dict(state_dict: Dict, path: str, strict: bool = True,
                    verify: bool = True) -> Dict:
    """Fills ``state_dict``'s tensors in place from ``path``, each
    reassembled from its saved shards and sliced for its split here
    (:func:`tensor_splits` on the current mesh); a value that is not a
    tensor is replaced by the whole array. ``strict``: every key must be
    in the checkpoint. ``verify``: each shard is held to its sha256
    (``CheckpointCorrupt`` otherwise)."""
    entries = _read_manifest(path)
    missing = [k for k in state_dict if k not in entries]
    if strict and missing:
        raise ValueError(f"checkpoint missing keys: {missing}")
    coords, degrees = _coords()
    for key, val in state_dict.items():
        if key not in entries:
            continue
        full = _assemble(path, entries[key], verify=verify)
        if isinstance(val, torch.Tensor):
            splits = tensor_splits(val)
            local = _local_slice(full, splits, coords, degrees,
                                 _blocks(val, splits, degrees))
            if tuple(local.shape) != tuple(val.shape):
                raise ValueError(f"{key}: checkpoint shape "
                                 f"{tuple(full.shape)} does not give the "
                                 f"target's {tuple(val.shape)} here")
            with torch.no_grad():
                val.copy_(local.to(val.dtype))
        else:
            state_dict[key] = full.numpy()
    return state_dict


def _plain_name(name: str) -> str:
    """A ZeRO-3 parametrized parameter under its plain name."""
    name = name.replace(".parametrizations.", ".")
    return name[:-len(".original")] if name.endswith(".original") else name


def _model_tensors(layer) -> Dict[str, torch.Tensor]:
    """{plain name: the parameter or buffer, split attributes kept}."""
    inner = getattr(layer, "_layers", layer)
    out = {}
    for n, p in inner.named_parameters():
        out.setdefault(getattr(p, "ckpt_name", None) or _plain_name(n), p)
    for n, b in inner.named_buffers():
        out.setdefault(_plain_name(n), b)
    return out


def _optimizer_tensors(layer, optimizer) -> Dict[str, torch.Tensor]:
    """{``opt.{parameter name}.{state}``: the state tensor}, each carrying
    the split of the tensor the optimizer updates."""
    names = {}
    for n, p in _model_tensors(layer).items():
        names[id(p)] = n
    out = {}
    for i, p in enumerate(optimizer._parameter_list):
        whole = getattr(p, "zero_full", None)
        name = names.get(id(whole if whole is not None else p),
                         optimizer._names[i])
        marked = whole if whole is not None else p
        splits = [(d, ax) for d, ax in ((getattr(marked, "ep_dim", None),
                                         "ep"),
                                        (getattr(marked, "mp_dim", None),
                                         "mp")) if d is not None]
        zdim = getattr(p, "zero3_dim", getattr(p, "zero_dim", None))
        if zdim is not None:
            splits.append((zdim, "sdp"))
        for k, v in optimizer._state.get(id(p), {}).items():
            v.ckpt_splits = _state_splits(v, p, splits)
            mp_dim = getattr(marked, "mp_dim", None)
            v.mp_blocks = getattr(marked, "mp_blocks", 1) if any(
                ax == "mp" and d == mp_dim for d, ax in v.ckpt_splits) else 1
            v.ckpt_copy = getattr(marked, "ckpt_copy", False)
            out[f"opt.{name}.{k}"] = v
    return out


def _state_splits(v, p, splits):
    """The split of an optimizer state ``v`` of tensor ``p`` (split as
    ``splits``): one of p's size splits as p does; Adafactor's row and
    column statistics (p's shape without its last dim, or without its
    second to last) as p's dims they keep, a mean over a split dim being
    whole on every rank; any other state whole."""
    if v.shape == p.shape:
        return list(splits)
    d = p.dim()
    if d >= 2 and tuple(v.shape) == tuple(p.shape[:-1]):        # vr
        return [(k, ax) for k, ax in splits if k < d - 1]
    if d >= 2 and tuple(v.shape) == tuple(p.shape[:-2]) + (p.shape[-1],):
        return [(k if k < d - 2 else k - 1, ax) for k, ax in splits
                if k != d - 2]                                      # vc
    return []


def save_sharded_model(layer, optimizer, path: str) -> None:
    """The model's parameters and buffers (under their plain names) and,
    with ``optimizer``, its state (``opt.{name}.{state}``) and step count
    (``opt.global_step``), each rank its part."""
    sd = dict(_model_tensors(layer))
    if optimizer is not None:
        optimizer._state_slots([p for p in optimizer._parameter_list
                                if p.requires_grad])
        sd.update(_optimizer_tensors(layer, optimizer))
        sd["opt.global_step"] = np.asarray(int(optimizer._global_step),
                                           np.int64)
    save_state_dict(sd, path)


def load_sharded_model(layer, optimizer, path: str) -> None:
    """The inverse of :func:`save_sharded_model` onto ``layer`` (and
    ``optimizer``) as they are split on the current mesh, whatever mesh
    saved them: parameters strictly, the optimizer's state where the
    checkpoint has it; a ZeRO stage 1 or 2 optimizer's slices are taken
    from the loaded parameters."""
    load_state_dict(_model_tensors(layer), path, strict=True)
    if optimizer is None:
        return
    coords, degrees = _coords()
    with torch.no_grad():
        for p in optimizer._parameter_list:
            whole = getattr(p, "zero_full", None)
            if whole is not None:
                p.copy_(whole.detach().chunk(degrees["sdp"],
                                             dim=p.zero_dim)[coords["sdp"]])
    optimizer._state_slots([p for p in optimizer._parameter_list
                            if p.requires_grad])
    sub = _optimizer_tensors(layer, optimizer)
    sub["opt.global_step"] = None
    load_state_dict(sub, path, strict=False)
    if sub["opt.global_step"] is not None:
        optimizer._global_step = int(sub["opt.global_step"])
