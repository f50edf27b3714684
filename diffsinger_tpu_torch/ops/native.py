"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded through ``ctypes``. A library
is built at its first use into ``build/`` beside this file (git-ignored); its
file name carries a hash of every source in ``csrc/`` and of the compiler
flags, so an edited source builds anew. :func:`build` compiles several
sources at once, one ``nvcc`` process each. The libraries link against the
CUDA runtime only; the one ``libcuda`` call they need
(``cuTensorMapEncodeTiled``) is looked up at run time in the ``libcuda`` that
PyTorch has loaded.

Nothing here runs at import time: the CPU tests import every module on hosts
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNEL_SOURCES = ("depthwise_conv", "lynx_fused", "flash_attention", "wavenet_block")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

# C signatures of every exported function: (library, name) -> argtypes.
# All return an int: the cudaError_t of cudaGetLastError() after the launch.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    ("depthwise_conv", "ds_dwconv_prelu"): (_P, _P, _P, _P, _P) + (_I,) * 8 + (_P,),
    ("lynx_fused", "ds_lynx_ln_stats"): (_P, _P, _P, _I, _I, _F, _I, _P),
    ("lynx_fused", "ds_lynx_pw1_swiglu"): (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    ("lynx_fused", "ds_lynx_pw2"): (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    ("flash_attention", "ds_flash_attn_fwd"): (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    ("flash_attention", "ds_flash_attn_bwd"): (_P,) * 11 + (_I, _I, _I, _I, _F, _I, _P),
    ("wavenet_block", "ds_wavenet_conv_gate"): (_P,) * 5 + (_I,) * 4 + (_P,),
    ("wavenet_block", "ds_wavenet_out_skip"): (_P,) * 6 + (_I, _F, _P, _P) + (_I,) * 4 + (_P,),
    ("wavenet_block", "ds_wavenet_conv_gate_bf16"): (_P,) * 5 + (_I,) * 4 + (_P,),
    ("wavenet_block", "ds_wavenet_out_skip_bf16"): (_P,) * 6 + (_I, _F, _P, _P) + (_I,) * 4 + (_P,),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Tuple[float, str]]:
    """Compile the named sources that are not built yet, all at once.

    Returns ``{name: (seconds, compiler messages)}`` for each source compiled
    here. Raises with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        msg, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{msg}")
            continue
        os.replace(tmp, out)
        report[name] = (time.perf_counter() - t0, msg)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for (lib_name, fn), argtypes in SIGNATURES.items():
                if lib_name == name:
                    f = getattr(lib, fn)
                    f.argtypes = list(argtypes)
                    f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def require(t: torch.Tensor, name: str, *, device, dtype, shape) -> None:
    """Raise unless ``t`` is what a kernel takes: device, dtype, shape, a
    contiguous layout and a 16-byte aligned start (the kernels load 16-byte
    vectors)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def stream_ptr(t) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(dtype) -> int:
    """The C side's element-type code: 0 = float32, 1 = bfloat16."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {dtype}")
