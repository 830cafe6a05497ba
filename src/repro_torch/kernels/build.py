"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``. Builds happen at first use (or all at once through
:func:`build`, which starts one ``nvcc`` per source in parallel) into
``src/repro_torch/_build/``, keyed by a hash of the source, the shared
headers and the flags, so an edited kernel rebuilds and an unchanged one
is reused. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("fleet_aggregate", "fake_quant", "flash_attention",
           "masked_matmul", "codebook_matmul")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the port's CUDA kernels are built at first use")
    return str(path)


def library_path(name: str) -> Path:
    """The library's path, keyed by the source, the shared headers of
    ``csrc/`` (``*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_log(name: str) -> str:
    """The compiler's report for ``name`` (``-Xptxas -v``: registers,
    shared memory, spills), empty if it was not built in this tree."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every library in ``names`` that is missing, one ``nvcc``
    process per source, all started together. Raises with the compiler's
    output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    procs = {}
    for name, lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        out[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        _libs[name] = lib
    return lib


def build_variants(name: str,
                   sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """Copies of ``csrc/<name>.cu`` with other text (``sources``: variant
    -> source), each compiled with the same flags (one ``nvcc`` per
    variant, all started together) into ``_build/ablation/`` and loaded.
    For measurements only: the port runs the sources as they are."""
    out_dir = BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for variant, src in sources.items():
        cu = out_dir / f"{name}_{variant}.cu"
        cu.write_text(src)
        procs[variant] = subprocess.Popen(
            [nvcc(), *FLAGS, "-I", str(CSRC), "-o",
             str(out_dir / f"lib{name}_{variant}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for variant, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {variant}:\n{log}")
        libs[variant] = ctypes.CDLL(str(out_dir / f"lib{name}_{variant}.so"))
    return libs
