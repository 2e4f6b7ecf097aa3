"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded with
``ctypes``.  Nothing is compiled when a module is imported: the first
:func:`load` of a kernel builds it, and :func:`build_all` builds every
source at once, one ``nvcc`` process per source, all started together.

Libraries go to ``build/torch_kernels/`` beside the package under a name
that carries a digest of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> nvcc's output of the last build in this process (ptxas prints
# each kernel's registers, shared memory and spills there)
build_logs: Dict[str, str] = {}


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built on the machine with the card")
    return nvcc


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Optional[List[str]] = None,
              force: bool = False) -> Dict[str, Path]:
    """Build the named kernels (default: every source) that are not
    built yet, or all of them with ``force``, one ``nvcc`` per source in
    parallel.  Returns name -> library path; raises with nvcc's output if
    any build fails."""
    names = kernel_names() if names is None else list(names)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if force or not out[n].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def timed_build_all(force: bool = False) -> Dict[str, object]:
    """Build every kernel and report seconds, library paths, what
    ``ptxas`` says of each kernel's registers, shared memory and spills,
    and its problems (:func:`ptxas_problems`) by source."""
    t0 = time.perf_counter()
    paths = build_all(force=force)
    return {"seconds": time.perf_counter() - t0,
            "libraries": {n: str(p) for n, p in paths.items()},
            "ptxas": {n: ptxas_summary(log) for n, log in build_logs.items()},
            "problems": {n: ptxas_problems(log)
                         for n, log in build_logs.items()}}


def ptxas_summary(log: str) -> Dict[str, str]:
    """kernel -> "Used N registers, ... bytes smem; S bytes stack frame,
    ... spill loads" from ``nvcc -Xptxas -v`` output; kernel names are
    shortened from their mangled form (``flash_fwd_bf16ILi64E...`` ->
    ``flash_fwd_bf16<64>``)."""
    out: Dict[str, str] = {}
    spills: Dict[str, str] = {}
    name = "?"
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", ln)
        if m:
            name = _short_name(m.group(1))
        elif "spill" in ln:
            spills[name] = ln.strip()
        elif "registers" in ln:
            out[name] = ln.split(":", 1)[-1].strip()
    return {n: f"{v}; {spills[n]}" if n in spills else v
            for n, v in out.items()}


def ptxas_problems(log: str) -> List[str]:
    """What in ``nvcc -Xptxas -v`` output says a kernel lost its design:
    spills to local memory, ``wgmma`` instructions that ptxas serialized
    (the products then run without overlap), and ``setmaxnreg`` that it
    ignored."""
    problems = []
    name = "?"
    for ln in log.splitlines():
        m = re.search(r"Function properties for ([^' ]+)", ln)
        if m:
            name = _short_name(m.group(1))
        s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if s and (int(s.group(1)) or int(s.group(2))):
            problems.append(f"{name}: {ln.strip()}")
        if "serialized" in ln or "setmaxnreg ignored" in ln:
            problems.append(ln.strip())
    return problems


def _short_name(symbol: str) -> str:
    """``_ZN12_GLOBAL__N_113flash_fwd_f32ILi64EEv..`` ->
    ``flash_fwd_f32<64>``: the last identifier of the (nested) name and
    its first integer template argument; an unmangled name stays."""
    m = re.match(r"_ZN?", symbol)
    if not m:
        return symbol
    i, name = m.end(), symbol
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        n = int(symbol[i:j])
        name, i = symbol[j:j + n], j + n
    t = re.match(r"ILi(\d+)E", symbol[i:])
    return f"{name}<{t.group(1)}>" if t else name
