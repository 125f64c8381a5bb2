"""The banded-SW x-drop CUDA kernel (native/sw_hopper.cu) as a JAX op.

The shared library is built from the committed source with ``make -C
native cuda`` (nvcc, sm_90a) into ``native/build/``, at first use when it
is missing or older than the source, and registered as an XLA FFI target
for the CUDA platform only: on any other backend the call fails to lower,
so the GPU path can never fall back to something else.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_NATIVE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SRC = os.path.join(_NATIVE, "sw_hopper.cu")
_SO = os.path.join(_NATIVE, "build", "libsw_hopper.so")
_TARGET = "npge_sw_xdrop"
_LOCK = threading.Lock()
_READY: list[ctypes.CDLL] = []


def _register() -> None:
    with _LOCK:
        if _READY:
            return
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            r = subprocess.run(
                ["make", "-C", _NATIVE, "cuda", f"PYTHON={sys.executable}"],
                capture_output=True, text=True, timeout=600,
            )
            if r.returncode != 0:
                raise RuntimeError(
                    f"building {_SO} failed:\n{r.stdout[-2000:]}{r.stderr[-4000:]}"
                )
        lib = ctypes.CDLL(_SO)
        jax.ffi.register_ffi_target(
            _TARGET, jax.ffi.pycapsule(lib.NpgeSwXdrop), platform="CUDA"
        )
        _READY.append(lib)  # keeps the library loaded


@partial(jax.jit, static_argnames=("L", "match", "mismatch", "gap", "xdrop"))
def sw_xdrop_cuda(qp, trp, qlen, tlen, *, L: int, match: int, mismatch: int,
                  gap: int, xdrop: int):
    """int32[P, 3] (best, best_i, best_j) from padded uint8[P, L+256] rows
    and int32[P] caps (<= L); band width 128."""
    _register()
    P = qp.shape[0]
    return jax.ffi.ffi_call(
        _TARGET, jax.ShapeDtypeStruct((P, 3), jnp.int32)
    )(
        qp, trp, qlen, tlen,
        L=np.int32(L), match=np.int32(match), mismatch=np.int32(mismatch),
        gap=np.int32(gap), xdrop=np.int32(xdrop),
    )
