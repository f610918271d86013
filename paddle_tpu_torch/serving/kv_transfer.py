"""KV-page shipping: pack, quantize, chunk, and cache paged-KV pages (port
of ``paddle_tpu/serving/kv_transfer.py``, host-side numpy, on the same wire
format).

- ``pack_kv_pages`` / ``unpack_kv_pages`` serialize per-layer K/V page
  stacks into one contiguous blob with a JSON-able manifest: fp32-exact
  (bit-identical install) or int8 with a per-page scale (~4x fewer transit
  bytes; dequantized on install). bf16 pages travel as their raw 16-bit
  words under the dtype name ``"bfloat16"``, as the JAX package writes
  them, so a blob packed by either package unpacks in the other.
- ``chunk_blob`` / ``assemble_chunks`` split the blob into base64 chunks
  with per-chunk SHA-256 plus a whole-blob digest, so a torn or corrupted
  transfer is detected and retried per chunk.
- ``FleetKVCache`` is the supervisor-side warm tier: packed payloads
  admitted by a frequency-gated ghost counter and evicted LRU under a
  byte budget.
- ``KVMigrationStats`` aggregates the page-shipping counters.

Page stacks are numpy arrays or CPU ``torch`` tensors; ``unpack_kv_pages``
returns CPU tensors (numpy has no bf16 without a package the port does
not use).
"""

from __future__ import annotations

import base64
import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "quantize_page",
    "dequantize_page",
    "pack_kv_pages",
    "unpack_kv_pages",
    "chunk_blob",
    "assemble_chunks",
    "payload_digest",
    "prompt_cache_key",
    "FleetKVCache",
    "KVMigrationStats",
]


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def payload_digest(blob: bytes) -> str:
    """SHA-256 hex digest of a packed page blob."""
    return _sha(blob)


def _float32(arr) -> np.ndarray:
    """fp32 numpy copy of a page (exact for bf16 and fp16)."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().to("cpu", torch.float32).numpy()
    return np.asarray(arr, dtype=np.float32)


# ---------------------------------------------------------------------------
# Per-page int8 quantization
# ---------------------------------------------------------------------------


def quantize_page(arr) -> Tuple[np.ndarray, float]:
    """Symmetric int8 quantization of one KV page.

    Returns ``(q, scale)`` with ``q = round(arr / scale)`` clipped to
    [-127, 127].  ``scale`` is strictly positive even for an all-zero
    page so dequantization never divides by zero.
    """
    a = _float32(arr)
    amax = float(np.max(np.abs(a))) if a.size else 0.0
    scale = max(amax / 127.0, 1e-12)
    q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_page(q: np.ndarray, scale: float, dtype: Any = np.float32):
    """Inverse of :func:`quantize_page` (lossy; error <= scale/2 per element
    before the cast). ``dtype`` names a numpy dtype (numpy result) or
    bf16 (``"bfloat16"`` / ``torch.bfloat16``: a CPU tensor, rounded to
    nearest even as the JAX package's cast rounds)."""
    f = np.asarray(q, dtype=np.float32) * float(scale)
    if _is_bf16(dtype):
        return torch.from_numpy(f).to(torch.bfloat16)
    if isinstance(dtype, torch.dtype):
        return torch.from_numpy(f).to(dtype)
    return f.astype(dtype)


# ---------------------------------------------------------------------------
# Pack / unpack
# ---------------------------------------------------------------------------


def _is_bf16(dtype) -> bool:
    return dtype is torch.bfloat16 or str(dtype) == "bfloat16"


def _dtype_name(arr) -> str:
    """The manifest's dtype name: numpy's, which the JAX package writes
    (``"float32"``, ``"bfloat16"``, ...)."""
    if isinstance(arr, torch.Tensor):
        return str(arr.dtype).replace("torch.", "")
    return str(np.asarray(arr).dtype)


def _raw(arr) -> bytes:
    """The page stack's bytes as the JAX package's ``tobytes`` gives them
    (C order, little endian; bf16 as its 16-bit words)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu").contiguous()
        if t.dtype is torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(arr).tobytes()


def pack_kv_pages(
    k_pages: Sequence[Any],
    v_pages: Sequence[Any],
    quantize: bool = False,
) -> Tuple[bytes, List[Dict[str, Any]], Dict[str, Any]]:
    """Serialize per-layer K/V page stacks into ``(blob, manifest, meta)``.

    ``k_pages[i]`` / ``v_pages[i]`` are ``[n_pages, page_len, heads, dim]``
    arrays or tensors for layer ``i``.  With ``quantize=True`` each page is
    stored int8 with a per-page fp32 scale in the manifest; otherwise pages
    are stored in their native dtype, byte-exact.  ``meta`` reports both
    the wire byte count and the fp32-equivalent byte count.
    """
    if len(k_pages) != len(v_pages):
        raise ValueError(f"layer mismatch: {len(k_pages)} K vs {len(v_pages)} V")
    manifest: List[Dict[str, Any]] = []
    parts: List[bytes] = []
    offset = 0
    fp32_bytes = 0
    npages = None
    for li in range(len(k_pages)):
        for tag, arr in (("k", k_pages[li]), ("v", v_pages[li])):
            shape = tuple(int(x) for x in arr.shape)
            if len(shape) != 4:
                raise ValueError(f"{tag}{li}: expected [n, page_len, heads, dim], got {shape}")
            if npages is None:
                npages = shape[0]
            elif shape[0] != npages:
                raise ValueError(f"{tag}{li}: page count {shape[0]} != {npages}")
            size = int(np.prod(shape))
            fp32_bytes += size * 4
            dtype = _dtype_name(arr)
            scales: Optional[List[float]] = None
            if quantize:
                a = _float32(arr)
                qs = []
                scales = []
                for p in range(shape[0]):
                    q, s = quantize_page(a[p])
                    qs.append(q)
                    scales.append(s)
                a = np.stack(qs, axis=0) if qs else np.zeros(shape, dtype=np.int8)
                raw, qdtype = a.tobytes(), "int8"
            else:
                raw, qdtype = _raw(arr), dtype
            manifest.append(
                {
                    "name": f"{tag}{li}",
                    "dtype": dtype,
                    "qdtype": qdtype,
                    "shape": list(shape),
                    "scales": scales,
                    "offset": offset,
                    "size": len(raw),
                }
            )
            parts.append(raw)
            offset += len(raw)
    blob = b"".join(parts)
    meta = {
        "npages": int(npages or 0),
        "layers": len(k_pages),
        "quantized": bool(quantize),
        "wire_bytes": len(blob),
        "fp32_bytes": fp32_bytes,
        "digest": _sha(blob),
    }
    return blob, manifest, meta


def _torch_dtype(name: str) -> torch.dtype:
    if _is_bf16(name):
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(name))).dtype


def _from_raw(seg: bytes, dtype: str, shape) -> torch.Tensor:
    if _is_bf16(dtype):
        words = np.frombuffer(seg, dtype=np.int16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(seg, dtype=np.dtype(dtype))
                            .reshape(shape).copy())


def unpack_kv_pages(
    blob: bytes, manifest: Sequence[Dict[str, Any]]
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Inverse of :func:`pack_kv_pages` -> ``(k_pages, v_pages)`` per layer,
    CPU tensors in each entry's original dtype. Quantized entries are
    dequantized with the per-page scales recorded in the manifest."""
    k_out: Dict[int, torch.Tensor] = {}
    v_out: Dict[int, torch.Tensor] = {}
    for ent in manifest:
        seg = blob[ent["offset"] : ent["offset"] + ent["size"]]
        shape = tuple(int(x) for x in ent["shape"])
        if ent.get("scales") is not None:
            q = np.frombuffer(seg, dtype=np.int8).reshape(shape)
            pages = [
                dequantize_page(q[p], ent["scales"][p], ent["dtype"])
                for p in range(shape[0])
            ]
            pages = [p if isinstance(p, torch.Tensor) else torch.from_numpy(p)
                     for p in pages]
            arr = (
                torch.stack(pages, dim=0)
                if pages
                else torch.zeros(shape, dtype=_torch_dtype(ent["dtype"]))
            )
        else:
            arr = _from_raw(seg, ent["qdtype"], shape)
        name = ent["name"]
        li = int(name[1:])
        (k_out if name[0] == "k" else v_out)[li] = arr
    layers = sorted(k_out)
    if layers != sorted(v_out):
        raise ValueError("manifest missing K or V entries for some layers")
    return [k_out[i] for i in layers], [v_out[i] for i in layers]


# ---------------------------------------------------------------------------
# Chunking (the weight-transfer wire discipline)
# ---------------------------------------------------------------------------


def chunk_blob(blob: bytes, chunk_bytes: int = 1 << 20) -> List[Dict[str, Any]]:
    """Split ``blob`` into base64 chunks with per-chunk SHA-256."""
    if chunk_bytes <= 0:
        raise ValueError("chunk_bytes must be positive")
    raws = [blob[i : i + chunk_bytes] for i in range(0, len(blob), chunk_bytes)] or [b""]
    return [
        {"idx": i, "data": base64.b64encode(raw).decode("ascii"), "sha": _sha(raw)}
        for i, raw in enumerate(raws)
    ]


def assemble_chunks(chunks: Sequence[Dict[str, Any]], digest: Optional[str] = None) -> bytes:
    """Reassemble chunks, verifying per-chunk SHA and the blob digest."""
    parts: List[bytes] = []
    for i, ch in enumerate(sorted(chunks, key=lambda c: c["idx"])):
        if int(ch["idx"]) != i:
            raise ValueError(f"chunk sequence broken at {i} (got idx {ch['idx']})")
        raw = base64.b64decode(ch["data"])
        if _sha(raw) != ch["sha"]:
            raise ValueError(f"chunk {i} SHA mismatch")
        parts.append(raw)
    blob = b"".join(parts)
    if digest is not None and _sha(blob) != digest:
        raise ValueError("assembled blob digest mismatch")
    return blob


# ---------------------------------------------------------------------------
# Fleet-wide warm tier
# ---------------------------------------------------------------------------


def prompt_cache_key(prompt_ids: Sequence[int], page_len: int) -> Optional[str]:
    """Stable key for the full-page prefix of a prompt (None if < 1 page)."""
    n = (len(prompt_ids) // page_len) * page_len
    if n <= 0:
        return None
    h = hashlib.sha256()
    h.update(str(page_len).encode("ascii"))
    for t in prompt_ids[:n]:
        h.update(int(t).to_bytes(8, "big", signed=True))
    return h.hexdigest()


class FleetKVCache:
    """Host-RAM warm tier for packed KV payloads, shared across the fleet.

    The supervisor stores the packed (typically int8) payload of each
    prefill it has seen; a repeat prompt is served from host RAM instead
    of re-prefilling or re-exporting.  Admission is frequency-gated with
    a ghost counter (an entry must be *seen* ``admit_threshold`` times
    before its bytes are kept), and residency is LRU under
    ``capacity_bytes``.
    """

    def __init__(
        self,
        capacity_bytes: int = 256 << 20,
        admit_threshold: int = 2,
        ghost_cap: int = 4096,
    ):
        self.capacity_bytes = int(capacity_bytes)
        self.admit_threshold = int(admit_threshold)
        self.ghost_cap = int(ghost_cap)
        self._entries: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._bytes = 0
        self._ghost: Dict[str, int] = {}
        self.hits = 0
        self.misses = 0
        self.admits = 0
        self.rejects = 0
        self.evictions = 0
        self._lock = threading.Lock()

    def note_access(self, key: str) -> None:
        with self._lock:
            self._ghost[key] = self._ghost.get(key, 0) + 1
            if len(self._ghost) > self.ghost_cap:
                self._ghost = {k: v // 2 for k, v in self._ghost.items() if v // 2 > 0}

    def admittable(self, key: str) -> bool:
        with self._lock:
            return self._ghost.get(key, 0) >= self.admit_threshold

    def get(self, key: Optional[str]) -> Optional[Dict[str, Any]]:
        if key is None:
            return None
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return ent

    def put(self, key: Optional[str], payload: Dict[str, Any]) -> bool:
        """Admit ``payload`` (a dict with a ``data`` bytes field) if warranted."""
        if key is None:
            return False
        self.note_access(key)
        nbytes = len(payload.get("data", b""))
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return True
            if nbytes > self.capacity_bytes or self._ghost.get(key, 0) < self.admit_threshold:
                self.rejects += 1
                return False
            while self._bytes + nbytes > self.capacity_bytes and self._entries:
                _, old = self._entries.popitem(last=False)
                self._bytes -= len(old.get("data", b""))
                self.evictions += 1
            self._entries[key] = payload
            self._bytes += nbytes
            self.admits += 1
            return True

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "capacity_bytes": self.capacity_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": (self.hits / total) if total else 0.0,
                "admits": self.admits,
                "rejects": self.rejects,
                "evictions": self.evictions,
                "ghost_entries": len(self._ghost),
            }


# ---------------------------------------------------------------------------
# Migration counters for the `kv_migration` provider
# ---------------------------------------------------------------------------


class KVMigrationStats:
    """Counters behind the ``kv_migration`` observability provider."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.ships = 0
        self.pages_shipped = 0
        self.wire_bytes = 0
        self.fp32_bytes = 0
        self.quantized_ships = 0
        self.exports = 0
        self.installs = 0
        self.install_ms_total = 0.0
        self.failover_ship = 0
        self.failover_reprefill = 0
        self.migrate_fallback = 0
        self.warm_hits = 0

    def note_ship(self, npages: int, wire_bytes: int, fp32_bytes: int, quantized: bool) -> None:
        with self._lock:
            self.ships += 1
            self.pages_shipped += int(npages)
            self.wire_bytes += int(wire_bytes)
            self.fp32_bytes += int(fp32_bytes)
            if quantized:
                self.quantized_ships += 1

    def note_install(self, ms: float) -> None:
        with self._lock:
            self.installs += 1
            self.install_ms_total += float(ms)

    def note_export(self) -> None:
        with self._lock:
            self.exports += 1

    def note_warm_hit(self) -> None:
        with self._lock:
            self.warm_hits += 1

    def note_fallback(self) -> None:
        with self._lock:
            self.migrate_fallback += 1

    def note_failover(self, ship: bool) -> None:
        with self._lock:
            if ship:
                self.failover_ship += 1
            else:
                self.failover_reprefill += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "ships": self.ships,
                "pages_shipped": self.pages_shipped,
                "wire_bytes": self.wire_bytes,
                "fp32_bytes": self.fp32_bytes,
                "transit_quantized_fraction": (
                    self.quantized_ships / self.ships if self.ships else 0.0
                ),
                "exports": self.exports,
                "installs": self.installs,
                "install_ms_avg": (
                    self.install_ms_total / self.installs if self.installs else 0.0
                ),
                "failover_ship": self.failover_ship,
                "failover_reprefill": self.failover_reprefill,
                "migrate_fallback": self.migrate_fallback,
                "warm_hits": self.warm_hits,
            }
