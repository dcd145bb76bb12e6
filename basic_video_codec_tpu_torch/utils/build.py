"""Build-at-first-use of the package's native shared libraries.

Both the host entropy codec (``native/entropy.cc``, g++) and the CUDA
kernels (``csrc/*.cu``, nvcc) are compiled into ``_build/`` beside the
package sources the first time they are needed, and rebuilt when the source
is newer than the library.  A failed build raises: there is no fallback.
"""

import os
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")


def build_shared(src: str, lib_name: str, compile_cmd: list[str]) -> str:
    """Compile ``src`` (a path relative to the package) into
    ``_build/<lib_name>`` with ``compile_cmd + ["-o", out, src]``, unless
    an up-to-date library is already there.  Returns the library's path.

    The library is written under a temporary name and renamed into place,
    so concurrent processes (test workers) never load a half-written file.
    """
    src_path = os.path.join(PKG_DIR, src)
    out = os.path.join(BUILD_DIR, lib_name)
    if (os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(src_path)):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        res = subprocess.run(compile_cmd + ["-o", tmp, src_path],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"building {src} failed ({' '.join(compile_cmd)}):\n"
                f"{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out
