"""Modules that run one of their functions when called.

``scan_tpu``'s packages re-export some functions under their own module's
name (``scan_tpu.ops.nms``, ``scan_tpu.engine.inference``). The port keeps
those names pointing at the modules, which its code and tests import as
modules, and makes each module callable, so ``ops.nms(...)`` and
``engine.inference(...)`` run the functions as in ``scan_tpu``.
"""

import sys
import types


def make_callable(module_name: str, fn_name: str) -> None:
    """Calling module ``module_name`` calls its attribute ``fn_name``, looked
    up at call time (so a patched attribute is the one called)."""

    class CallableModule(types.ModuleType):
        def __call__(self, *args, **kwargs):
            return getattr(self, fn_name)(*args, **kwargs)

    sys.modules[module_name].__class__ = CallableModule
