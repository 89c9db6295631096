"""Build and bind the hand-written CUDA kernels (ctypes, plain C entry points).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into
``<repo>/build/kernels/lib<name>-<hash>.so`` at first use; the hash covers
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
kernel or header rebuilds and an unchanged one loads from disk.
:func:`build` compiles several sources at once, one ``nvcc`` process per
source, all started together, and keeps each build's ``ptxas -v`` report
beside its library (:func:`ptxas_usage` reads it).
Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
from typing import Dict, Iterable, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entry points, per source file
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "gemm": {"gemm_launch": (_I, [_P, _P, _P] + [_I] * 12 + [_P]),
             "splitk_reduce_launch": (_I, [_P, _P] + [_I] * 4 + [_P])},
    "conv": {"conv_launch": (_I, [_P, _P, _P] + [_I] * 16 + [_P])},
    "attention": {"attention_launch": (_I, [_P] * 4 + [_I] * 12
                                       + [ctypes.c_float, _P])},
    "ssd": {"ssd_launch": (_I, [_P] * 6 + [_I] * 9 + [_P])},
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> None:
    """Compile every missing library among ``names``: one ``nvcc`` per
    source, all started together; raise with the output of any that
    failed (after every process has ended)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in dict.fromkeys(names):
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)    # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_usage(name: str) -> Dict[str, Tuple[int, int]]:
    """(registers, spill bytes stored + loaded) of every kernel in the
    built ``csrc/<name>.cu``, by mangled name, from its ``ptxas -v``
    report."""
    log = library_path(name).with_suffix(".log").read_text()
    usage: Dict[str, Tuple[int, int]] = {}
    kernel, spill = None, 0
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            kernel, spill = m.group(1), 0
        elif m := _SPILL.search(line):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := _REGS.search(line)) and kernel:
            usage[kernel] = (int(m.group(1)), spill)
            kernel = None
    return usage


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _LIBS[name] = lib
    return lib
