"""Time the native host library's build two ways on this machine, each
from nothing in a fresh copy of cybervision_tpu_torch/native/:

* "one g++": every source in one serial g++ call (the rule of the
  Makefile before it built one object a source);
* "make -jN": the Makefile's rule, one object a source compiled in
  parallel (N = the CPU count, as native.load runs it), then linked;

then each source's object alone, one after another ("object_seconds":
what bounds make -jN is its slowest object). Both builds give a
libcvtorch_native.so of the same sources and flags. Prints one JSON
line: the seconds of each build and object, and the CPU count.

    python tools/native_build_times.py
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "cybervision_tpu_torch", "native")


def _makefile_var(name: str) -> str:
    with open(os.path.join(NATIVE, "Makefile")) as fh:
        text = fh.read()
    return re.search(rf"^{name} \??= (.*)$", text, re.M).group(1).strip()


def main() -> int:
    sources = _makefile_var("SOURCES").split()
    flags = _makefile_var("CXXFLAGS").split()
    cpus = os.cpu_count() or 1
    runs = {}
    for name, argv in (
        ("one g++", ["g++", *flags, "-shared", "-pthread", "-o", "libcvtorch_native.so",
                     *sources]),
        (f"make -j{cpus}", ["make", "-s", f"-j{cpus}", "libcvtorch_native.so"]),
    ):
        with tempfile.TemporaryDirectory() as td:
            work = os.path.join(td, "native")
            shutil.copytree(NATIVE, work, ignore=shutil.ignore_patterns("*.so", "*.o", "*.tmp"))
            t0 = time.perf_counter()
            subprocess.run(argv, cwd=work, check=True, capture_output=True)
            runs[name] = round(time.perf_counter() - t0, 3)
            if not os.path.exists(os.path.join(work, "libcvtorch_native.so")):
                print(f"{name}: no library built", file=sys.stderr)
                return 1
    objects = {}
    with tempfile.TemporaryDirectory() as td:
        work = os.path.join(td, "native")
        shutil.copytree(NATIVE, work, ignore=shutil.ignore_patterns("*.so", "*.o", "*.tmp"))
        for src in sources:
            t0 = time.perf_counter()
            subprocess.run(["g++", *flags, "-pthread", "-c", "-o", "x.o", src], cwd=work,
                           check=True, capture_output=True)
            objects[src] = round(time.perf_counter() - t0, 3)
    print(json.dumps({"build_seconds": runs, "object_seconds": objects, "sources": len(sources),
                      "cpus": cpus}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
