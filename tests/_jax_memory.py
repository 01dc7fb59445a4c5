"""Keep a test worker's memory in check between the port's test modules.

A pytest-xdist worker runs many test files in one process. The JAX
package's tests and the port's reference comparisons compile XLA programs
that stay cached for the life of the process, and glibc keeps the heap
pages they free, so a worker grows to many GB (9-16 GB each at six workers
on a 62 GB machine, where the kernel then stalls on memory or kills a
worker). Every port test module imports the autouse fixture below: before
the module's first test, in a worker that holds more than LIMIT bytes, it
drops JAX's in-memory compilation caches (what a test needs again comes
back from the persistent cache under .xla_cache) and returns the freed
heap to the system. A worker under the limit keeps its caches."""

import ctypes
import gc
import os

import jax
import pytest

LIMIT = 4 << 30


def _resident_bytes():
    """This process's resident set size, or None where /proc has none."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, ValueError, IndexError):
        return None
    return pages * os.sysconf("SC_PAGE_SIZE")


def _malloc_trim():
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):      # not glibc
        pass


@pytest.fixture(scope="module", autouse=True)
def release_jax_memory():
    rss = _resident_bytes()
    if rss is not None and rss > LIMIT:
        jax.clear_caches()
        gc.collect()
        _malloc_trim()
    yield
