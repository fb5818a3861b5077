"""Build and load the port's CUDA kernels at first use.

Every ``csrc/*.cu`` source (with the ``csrc/*.cuh`` headers it includes)
compiles with its own ``nvcc`` process (all started together) into an
object, and the objects link into one shared library with a plain C
interface, loaded with `ctypes`. The library lands in
``build/kernels/<hash>/`` at the root of the checkout; the hash covers the
sources, the headers and the flags, so an edited source or header builds
anew and an unchanged tree loads the library already there. Nothing here runs at import time: the first
kernel launch on a CUDA tensor (or an explicit `load()`) builds. `launch`
is the wrappers' one way into the library: it calls a C launcher on
PyTorch's current stream and raises on the CUDA error it returns.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libreprotorch_kernels.so"

_LIB: Optional[ctypes.CDLL] = None
#: seconds the last `load()` spent compiling (0.0 when it found a build)
BUILD_SECONDS = 0.0
#: `-Xptxas -v` report of the last compile (registers, shared memory, spills)
PTXAS_LOG = ""


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels cannot be built")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list:
    return sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> str:
    """Compile every source in parallel, then link; returns the ptxas log."""
    nvcc = nvcc_path()
    procs = []
    for src in sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    lib_tmp = out_dir / (LIB_NAME + ".tmp")
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(lib_tmp),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    return "\n".join(logs)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                        i32, i32, f32, i32, i32, vp]
    lib.flash_attention_fwd.restype = i32
    lib.moe_topk_fwd.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, vp]
    lib.moe_topk_fwd.restype = i32
    lib.ssd_scan_fwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32, i32, i32,
                                 i32, i32, i32, i32, i32, vp]
    lib.ssd_scan_fwd.restype = i32
    lib.launch_floor.argtypes = [vp]
    lib.launch_floor.restype = i32
    return lib


def load() -> ctypes.CDLL:
    """The kernels' library, built from the checkout's sources if no build
    of these exact sources exists yet. Raises if ``nvcc`` is missing or a
    source does not compile."""
    global _LIB, BUILD_SECONDS, PTXAS_LOG
    if _LIB is not None:
        return _LIB
    final = BUILD_ROOT / source_hash()
    lib_path = final / LIB_NAME
    t0 = time.perf_counter()
    if not lib_path.is_file():
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        work = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
        try:
            PTXAS_LOG = _compile(work)
            (work / "build.log").write_text(PTXAS_LOG)
            os.replace(work / (LIB_NAME + ".tmp"), work / LIB_NAME)
            try:
                os.replace(work, final)      # atomic publish of the build
            except OSError:                  # another process published first
                pass
        finally:
            shutil.rmtree(work, ignore_errors=True)
        BUILD_SECONDS = time.perf_counter() - t0
    else:
        BUILD_SECONDS = 0.0
        log = final / "build.log"
        PTXAS_LOG = log.read_text() if log.is_file() else ""
    _LIB = _declare(ctypes.CDLL(str(lib_path)))
    return _LIB


def _raw_stream(index: int) -> int:
    """The handle of PyTorch's current stream on device ``index`` (the raw
    handle where this PyTorch exposes it, which skips building a `Stream`)."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(index) if raw else torch.cuda.current_stream(index).cuda_stream


def launch(name: str, device, *args) -> None:
    """Call the library's C launcher ``name(*args, stream)`` on PyTorch's
    current stream of the CUDA ``device``, which is made the current device
    only for the call and only if it is not already; raise `RuntimeError` if
    the launcher returns a CUDA error."""
    import torch
    fn = getattr(_LIB or load(), name)
    current = torch.cuda.current_device()
    if device.index is None or device.index == current:
        err = fn(*args, _raw_stream(current))
    else:
        with torch.cuda.device(device.index):
            err = fn(*args, _raw_stream(device.index))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
