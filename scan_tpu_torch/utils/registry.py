"""Minimal string->factory registry (counterpart of
``scan_tpu/utils/registry.py``; reference ``fcos_core/utils/registry.py``)."""


class Registry(dict):
    def register(self, name):
        def deco(fn):
            self[name] = fn
            return fn

        return deco
