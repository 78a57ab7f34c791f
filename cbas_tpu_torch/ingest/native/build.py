"""Build the native decoder shared library (g++ + libav dev headers).

Copy of ``cbas_tpu/ingest/native/build.py`` for the port, which imports nothing of ``cbas_tpu``;
``tests/test_torch_copies.py`` holds the two equal.

Invoked automatically on first use (ingest/native/loader.py) and cacheable:
the .so lands in the package's gitignored ``_build/``. Also runnable directly:

    python -m cbas_tpu_torch.ingest.native.build
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "decoder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(HERE)), "_build")
LIB = os.path.join(BUILD_DIR, "libcbasdecoder.so")

LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]


def build(force: bool = False) -> str:
    """Compile decoder.cpp -> _build/libcbasdecoder.so; returns the path.

    The library lives outside the package's importable namespace (pkgutil
    walkers would otherwise try to import it as an extension module).
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    if not force and os.path.exists(LIB):
        # A packaged install may ship only the prebuilt .so (decoder.cpp
        # stripped): a missing source never invalidates an existing library.
        if not os.path.exists(SRC) or os.path.getmtime(LIB) >= os.path.getmtime(SRC):
            return LIB
    # Per-process tmp name: two processes racing on first use must not write
    # the same tmp path, or one's os.replace can install the other's
    # half-written object (then every CDLL fails for the process lifetime).
    tmp = f"{LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O2", "-fPIC", "-shared", "-std=c++17",
        SRC, "-o", tmp,
    ] + LIBS
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, LIB)  # atomic; last writer wins with a complete .so
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIB


def main() -> None:
    try:
        path = build(force="--force" in sys.argv)
        print(f"built {path}")
    except subprocess.CalledProcessError as e:
        print(e.stderr, file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
