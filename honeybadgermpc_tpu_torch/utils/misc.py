"""Small helpers (reference utils/misc.py).

Counterpart of ``honeybadgermpc_tpu/utils/misc.py``, so far only
``print_exception_callback`` (:14-19), which the AsynchroMix app's server
loops attach to their tasks."""

from __future__ import annotations

import logging


def print_exception_callback(future):
    if future.done() and not future.cancelled():
        ex = future.exception()
        if ex is not None:
            logging.critical("Task exception: %r", ex, exc_info=ex)
            raise ex
