"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>-<hash>.so`` at the root of
the checkout, keyed by a hash of the source, the headers under ``csrc/`` and
the flags, so an edited source is rebuilt and an unchanged one is loaded as
it is. The first call builds every missing library at once, one nvcc process
per source, all started together. Each library exposes a plain C interface;
every function returns ``cudaGetLastError()`` after its launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("graph_attention", "graph_attention_bwd", "ffn", "flash_graph_attention",
           "flash_graph_attention_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (on PATH or under /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers, shared memory, spills) of the last build."""
    log = BUILD_DIR / f"{name}.log"
    return log.read_text() if log.exists() else ""


def _kernel_name(mangled: str) -> tuple:
    """(name, template arguments) of a mangled kernel: the length-prefixed
    identifier ending in ``_kernel`` whose prefix is its length (a hash in
    the anonymous namespace's name may end in digits too)."""
    for m in re.finditer(r"(?=(\d+)[A-Za-z_])", mangled):
        digits = m.group(1)
        start = m.start() + len(digits)
        ident = mangled[start:start + int(digits)]
        if ident.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", ident):
            t = re.match(r"I(.*?)E(?:E|v)", mangled[start + len(ident):])
            return ident, t.group(1) if t else ""
    return mangled, ""


def register_lines(log: str) -> list:
    """ptxas's registers and spills per kernel from an nvcc -Xptxas -v log:
    ``["name<template args>: Used N registers, ...; S bytes spill stores, L
    bytes spill loads", ...]``."""
    out, name, spills = [], "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1] if "'" in line else line
            spills = ""
            name, template = _kernel_name(mangled)
            if template:
                args = re.findall(r"Li(\d+)|(13__nv_bfloat16)|(f)", template)
                name += "<" + ", ".join(a or ("bf16" if b else "float") for a, b, _ in args) + ">"
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spills}")
    return out


def build_all() -> list:
    """Build every library that is missing; return the names built.

    Raises ``RuntimeError`` with nvcc's output if any source fails.
    """
    with _lock:
        missing = [n for n in SOURCES if not library_path(n).exists()]
        if not missing:
            return []
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for name in missing:
            lib = library_path(name)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs.append((name, lib, tmp, proc))
        errors = []
        for name, lib, tmp, proc in jobs:
            out, _ = proc.communicate()
            (BUILD_DIR / f"{name}.log").write_text(out)
            if proc.returncode != 0:
                errors.append(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, lib)
        if errors:
            raise RuntimeError("\n".join(errors))
        return missing


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                _libs[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
