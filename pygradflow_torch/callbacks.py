"""User callback registry (reference ``pygradflow/callbacks.py``).

The only event fired by the solve loop is ``ComputedStep`` per outer iteration
(reference ``solver.py:331``).  The eager loop calls them directly with the
step's tensors; they run for their side effects and cannot influence the
solve.
"""

from enum import Enum, auto


class CallbackType(Enum):
    ComputedStep = auto()


class CallbackHandle:
    def __init__(self, callbacks, type, func):
        self.callbacks = callbacks
        self.type = type
        self.func = func

    def unregister(self):
        self.callbacks._unregister(self)


class Callbacks:
    def __init__(self):
        self._callbacks = {t: [] for t in CallbackType}

    def register(self, type: CallbackType, func) -> CallbackHandle:
        handle = CallbackHandle(self, type, func)
        self._callbacks[type].append(handle)
        return handle

    def _unregister(self, handle):
        self._callbacks[handle.type].remove(handle)

    def __call__(self, type: CallbackType, *args):
        for handle in list(self._callbacks[type]):
            handle.func(*args)

    def empty(self, type: CallbackType) -> bool:
        return not self._callbacks[type]
