"""Write the golden vectors of the port's parity tests (tests/_golden.py).

Runs the JAX reference on the CPU for every entry of the ``GOLDEN`` tables
of the modules in ``_golden.MODULES`` and stores each result as
``tests/golden/<name>.npz``. Sets up JAX as tests/conftest.py does (CPU, 8
virtual devices, the persistent compilation cache under .xla_cache), so
the stored arrays are the ones the tests computed live.

    python tests/make_golden.py            # every golden vector
    python tests/make_golden.py NAME ...   # only these
"""

import importlib
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8"
                           + " --xla_cpu_parallel_codegen_split_count=1")
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(HERE, "..", ".xla_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402

import _golden  # noqa: E402


def main(names):
    os.makedirs(_golden.DIR, exist_ok=True)
    for modname in _golden.MODULES:
        mod = importlib.import_module(modname)
        for name, fn in mod.GOLDEN.items():
            if names and name not in names:
                continue
            arrays = fn()
            np.savez_compressed(os.path.join(_golden.DIR, name + ".npz"),
                                **arrays)
            size = sum(a.nbytes for a in arrays.values())
            print(f"{name}: {len(arrays)} arrays, {size} bytes", flush=True)


if __name__ == "__main__":
    main(set(sys.argv[1:]))
