"""Native (C++) host-side components: the ray tracer behind
`utils.render.render_state_native` (`csrc/render.cpp`, the JAX package's
`native/render.cpp` byte for byte), built with g++ at first use into
`_build/` under its content hash, as the kernels' host twin is
(`ops.cuda_engine.HostTwin`), and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil

RENDER_FLAGS = ("-O2", "-shared", "-fPIC")


@functools.lru_cache(maxsize=None)
def load_render_lib():
    """Build (once per source hash) and load librender. Returns None only
    where there is no g++; a build that fails raises with the compiler's
    output."""
    from pybulletgym_tpu_torch.ops.cuda_engine import BUILD_DIR, _compile, _sources

    gxx = shutil.which("g++")
    if gxx is None:
        return None
    h = _sources(["render.cpp"])
    h.update(" ".join(RENDER_FLAGS).encode())
    name = f"librender_{h.hexdigest()[:16]}.so"
    _compile([([gxx], "render.cpp", name, RENDER_FLAGS)])
    lib = ctypes.CDLL(os.path.join(BUILD_DIR, name))
    lib.render_rgb.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_float,
        ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
    ]
    lib.render_rgb.restype = None
    return lib
