"""A minimal name->object registry (counterpart of
``ldpc_decoders_tpu.utils.registry``): put/get/reg/keys."""

from __future__ import annotations

from collections import OrderedDict


class Registry:
    def __init__(self):
        self._d = OrderedDict()

    def put(self, key, val):
        self._d[key] = val
        return val

    def get(self, key):
        return self._d[key]

    def reg(self, func):
        """Decorator: register a callable under its __name__."""
        self._d[func.__name__] = func
        return func

    def keys(self):
        return list(self._d.keys())

    def items(self):
        return list(self._d.items())

    def __contains__(self, key):
        return key in self._d
