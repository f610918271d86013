"""Containers (port of ``paddle_tpu/nn/layer/container.py``):
``Sequential``, ``LayerList``, ``LayerDict``, ``ParameterList``. Entries
are named ``"0"``, ``"1"``, ... (or by the given names), as paddle's are,
so their ``state_dict`` names are the JAX package's."""
from __future__ import annotations

import collections

from .layers import Layer

__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList"]


class Sequential(Layer):
    """``Sequential(l0, l1, ...)``, ``Sequential(("name", layer), ...)``
    or ``Sequential(OrderedDict)``; ``forward`` calls them in order."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], collections.OrderedDict):
            layers = tuple(layers[0].items())
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_sublayer(layer[0], layer[1])
            else:
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        subs = list(self._modules.values())
        if isinstance(idx, slice):
            return Sequential(*subs[idx])
        return subs[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or []):
            self.add_sublayer(str(i), layer)

    def _key(self, idx):
        return str(idx if idx >= 0 else len(self) + idx)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return self._modules[self._key(idx)]

    def __setitem__(self, idx, layer):
        self.add_sublayer(self._key(idx), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, layer in enumerate(layers):
            self.add_sublayer(str(i), layer)

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        if isinstance(sublayers, dict):
            sublayers = sublayers.items()
        for k, v in sublayers:
            self.add_sublayer(k, v)

    def pop(self, key):
        return self._modules.pop(key)

    def clear(self):
        self._modules.clear()


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or []):
            self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx if idx >= 0 else len(self) + idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self)), parameter)
        return self
