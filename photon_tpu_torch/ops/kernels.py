"""Build, load and count the port's CUDA kernels.

Each source in ``photon_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``. Libraries are built at first use (or all at once, in parallel,
by ``build_all``) into ``build/torch_kernels/`` beside the package, under a
name keyed by the hash of the source and every header in ``csrc/``, so an
edited source or header is rebuilt and an unchanged one is reused.

Every wrapper that launches a kernel adds one to that kernel's entry in
``LAUNCHES``, where it launches and nowhere else: a run shows which kernels
its path went through by resetting the counts before and reading them
after. A launch made while a CUDA graph is being captured runs only when
the graph is replayed, so the solve cache (algorithm/solve_cache.py) takes
the capture's counts back (``snapshot``, ``restore``) and adds them on every
replay that ran them (``add``); the counts stay the launches the card ran.
Wrappers may keep finer counts of their own (``register_counts``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"

_VP = ctypes.c_void_p
_I = ctypes.c_int

# name -> (source file, C entry point, argtypes)
KERNELS: Dict[str, Tuple[str, str, list]] = {
    "fused_value_grad": (
        "fused_value_grad.cu", "pt_fused_value_grad",
        [_VP, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _I, _VP],
    ),
    "fused_hvp": (
        "fused_hvp.cu", "pt_fused_hvp",
        [_VP, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _VP],
    ),
    "newton_system": (
        "newton_system.cu", "pt_newton_system",
        [_VP, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _VP],
    ),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# Every launch count: LAUNCHES and the finer ones of register_counts.
_COUNTS: List[Dict] = [LAUNCHES]

_LOADED: Dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def register_counts(counts: Dict) -> None:
    """Have the solve cache keep ``counts`` (a wrapper's own launch counts,
    by any key) through capture and replay, as it keeps LAUNCHES."""
    _COUNTS.append(counts)


def snapshot() -> List[Dict]:
    return [dict(c) for c in _COUNTS]


def restore(snap: List[Dict]) -> None:
    for c, s in zip(_COUNTS, snap):
        c.clear()
        c.update(s)


def counted_since(snap: List[Dict]) -> List[Dict]:
    """The launches counted since ``snap``, per count and key."""
    return [{k: v - s.get(k, 0) for k, v in c.items() if v != s.get(k, 0)} for c, s in zip(_COUNTS, snap)]


def add(counted: List[Dict], times: int = 1) -> None:
    """Count ``counted`` (from ``counted_since``) ``times`` more times."""
    for c, d in zip(_COUNTS, counted):
        for k, v in d.items():
            c[k] = c.get(k, 0) + v * times


def _nvcc() -> str:
    cand = Path("/usr/local/cuda/bin/nvcc")
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def _library_path(name: str) -> Path:
    src = KERNELS[name][0]
    h = hashlib.sha256()
    for f in [CSRC / src, *sorted(CSRC.glob("*.h"))]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _nvcc_command(name: str, out: Path) -> list:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
        "-o", str(out), str(CSRC / KERNELS[name][0]),
    ]


def build_all(names=None) -> Dict[str, dict]:
    """Compile the named kernels (default: all), one ``nvcc`` per source,
    all started together. Returns per kernel the build seconds, whether it
    was already built, and the ``-Xptxas -v`` lines (registers, shared
    memory, spills). Raises with the compiler's output if a build fails."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, report = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = _library_path(name)
        if out.exists():
            report[name] = dict(seconds=0.0, cached=True, ptxas=[])
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _nvcc_command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        lines = [ln for ln in text.splitlines() if "ptxas" in ln]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            continue
        tmp.replace(out)
        report[name] = dict(seconds=time.perf_counter() - t0, cached=False, ptxas=lines)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def symbol(name: str, sym: str, argtypes: list):
    """Function ``sym`` (returning an int) of kernel ``name``'s library,
    built and loaded on first use."""
    fn = _LOADED.get(sym)
    if fn is None:
        path = _library_path(name)
        if not path.exists():
            build_all([name])
        fn = getattr(ctypes.CDLL(str(path)), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[sym] = fn
    return fn


def query_int(name: str, sym: str, *args: int) -> int:
    """Call ``sym(*args, int* out)`` of kernel ``name``'s library, which
    launches nothing, and return ``out``; raise if it returns an error."""
    out = ctypes.c_int(0)
    fn = symbol(name, sym, [_I] * len(args) + [ctypes.POINTER(ctypes.c_int)])
    err = fn(*args, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"{name}: {sym} failed with cudaError_t {err}")
    return out.value


def entry(name: str):
    """The C entry point of kernel ``name``, built and loaded on first use."""
    return symbol(name, KERNELS[name][1], KERNELS[name][2])


def launch(name: str, *args) -> None:
    """Call kernel ``name`` on the current stream, raise if the launch was
    refused, and count the launch."""
    stream = torch.cuda.current_stream().cuda_stream
    err = entry(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    LAUNCHES[name] += 1


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got {dev}")
