"""Build the C++ host library ahead of time:
``python -m gpsat_tpu_torch.build_native``.

The library (``csrc/host/gpsat_native.cpp``) is otherwise built at first
use; either way ``ops/_build.py`` runs ``g++ -O3 -march=native -std=c++17
-shared -fPIC -pthread`` into ``gpsat_tpu_torch/build/``, under a name
hashed from the source, the flags, the compiler and the CPU's features. A
failed build raises.
"""

import sys
import time

from gpsat_tpu_torch.ops import _build


def main() -> str:
    t0 = time.perf_counter()
    path = _build.build_host_library("gpsat_native")
    print(f"built: {path} ({time.perf_counter() - t0:.2f} s)")
    return str(path)


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
