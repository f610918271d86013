"""Control-plane KV store (port of ``paddle_tpu/distributed/store``:
reference ``paddle/fluid/distributed/store/tcp_store.h`` TCPStore).

The JAX package binds its own C++ daemon (``store.cpp``) through ctypes.
The store is control plane, not a kernel, and PyTorch ships one:
this module keeps the JAX class's signature and methods over
``torch.distributed.TCPStore``. A master asked for port 0 binds a free
port and reports it in ``.port``. ``get`` of an absent key blocks until
the store's timeout, as the JAX store's does; the fleet's probes go
through ``add(key + "/published", 0)`` instead (``fleet.runtime._probe``).
"""
from __future__ import annotations

import datetime
from typing import Optional

__all__ = ["TCPStore", "Store"]


class Store:
    """Abstract store API (reference store.h)."""

    def set(self, key: str, value):  # pragma: no cover - interface
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def add(self, key: str, amount: int) -> int:
        raise NotImplementedError

    def wait(self, keys):
        raise NotImplementedError


class TCPStore(Store):
    """TCP-backed KV store. The designated master (``is_master=True``)
    hosts the server; every process (master included) talks to it as a
    client."""

    def __init__(self, host="127.0.0.1", port=0, is_master=False,
                 world_size=1, timeout=900):
        from torch.distributed import TCPStore as _TorchStore

        if not is_master and not port:
            raise ValueError("non-master TCPStore needs the master's port")
        self.host = host
        self.world_size = int(world_size)
        self.timeout = int(timeout)
        # no rendezvous on construction: the JAX store's clients connect
        # and go, whatever world_size says
        self._s: Optional[_TorchStore] = _TorchStore(
            host, int(port), None, bool(is_master),
            timeout=datetime.timedelta(seconds=max(self.timeout, 1)),
            wait_for_workers=False)
        self.port = int(self._s.port)

    def _store(self):
        if self._s is None:
            raise RuntimeError("TCPStore is closed")
        return self._s

    # -- Store API -----------------------------------------------------------
    def set(self, key: str, value):
        data = value if isinstance(value, (bytes, bytearray)) else \
            str(value).encode()
        self._store().set(key, bytes(data))

    def get(self, key: str) -> bytes:
        store = self._store()
        try:
            return bytes(store.get(key))
        except RuntimeError as e:  # DistStoreError: the timeout expired
            raise TimeoutError(f"TCPStore.get({key}) failed or timed out "
                               f"after {self.timeout}s: {e}") from None

    def add(self, key: str, amount: int = 1) -> int:
        return int(self._store().add(key, int(amount)))

    def wait(self, keys, timeout=None):
        """Block until every key exists; ``timeout`` (seconds) overrides
        the store-level one for this call only. Raises ``TimeoutError``."""
        keys = list(keys) if isinstance(keys, (list, tuple)) else [keys]
        t = self.timeout if timeout is None else max(1, int(timeout))
        store = self._store()
        try:
            store.wait(keys, datetime.timedelta(seconds=t))
        except RuntimeError as e:
            raise TimeoutError(f"TCPStore.wait({keys}) failed or timed out "
                               f"after {t}s: {e}") from None

    def delete_key(self, key: str) -> bool:
        return bool(self._store().delete_key(key))

    def close(self):
        """Drop the connection (and, on the master, stop the server)."""
        self._s = None
