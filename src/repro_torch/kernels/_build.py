"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``.cu`` under ``kernels/csrc/`` is compiled for ``sm_90a`` into its own
object, all ``nvcc`` processes at once, and the objects are linked once into
one shared library with a plain C interface, at first use, into
``build/repro_torch_kernels/`` at the root of the checkout. The library's name
carries a hash of the sources and flags, so a stale build is never loaded. A
failed build raises; there is no fallback.

Nothing here runs at import: the CPU tests import every module, and there is no
``nvcc`` where they run.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of every kernel
)
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C entry points: name -> argument types. Each returns an int: a launcher
#: its launch's ``cudaError_t``, a query a size in bytes.
SIGNATURES = {
    # x, z, v, b, workspace, out, n, m, d, s, kind, rows_true, width, chunk,
    # rows_per_cta, stream
    "repro_gram_matvec_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _P),
    # the same with bf16 tiles (gram_matvec_bf16.cu)
    "repro_gram_matvec_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               _P),
    # x, z, v, workspace, out, n, m, d, s, kind, signal, jitter, width, chunk,
    # rows_per_cta, stream: the in-kernel signal and jitter, fp32 and bf16 tiles
    "repro_gram_matvec_scaled_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I,
                                     _I, _I, _P),
    "repro_gram_matvec_scaled_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I,
                                      _I, _I, _P),
    # x, z, rowv, colv, workspace, out, n, m, d, s, kind, width, chunk,
    # stage2_tc, stream
    "repro_gram_matvec_bwd_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _P),
    # the same with bf16 tiles, no stage2_tc (gram_matvec_bwd_bf16.cu)
    "repro_gram_matvec_bwd_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, omega, w, workspace, out, n, m, d, s, width, freq_chunk, stream
    "repro_rff_matvec_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # xi, x, look, b, workspace, err, g, p, n, d, s, kind, p_true, width,
    # chunk0, rows_per_cta0, chunk2, rows_per_cta2, stream
    "repro_gram_rows_pair_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _P),
    # x, omega, u, workspace, t, n, m, d, s, m_true, width, row_chunk, stream
    "repro_rff_t_matvec_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, omega, u, workspace, t, out, n, m, d, s, m_true, width, row_chunk,
    # freq_chunk, stream
    "repro_rff_pair_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # the four above with bf16 tiles (gram_rows_pair.cu, rff_matvec_bf16.cu)
    "repro_gram_rows_pair_bf16": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _P),
    "repro_rff_matvec_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "repro_rff_t_matvec_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "repro_rff_pair_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # r, c, p1, p2, q1, q2, workspace, out, rows, cols, d, s, scale, width,
    # chunk, products_tc, stream
    "repro_rff_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I,
                          _P),
    # the same with bf16 tiles, no products_tc (rff_bwd_bf16.cu)
    "repro_rff_bwd_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P),
    # q, k, v, out, b, s, hq, hkv, d, causal, scale, stream
    "repro_flash_attention_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # the same on bf16 tensors (flash_attention_bf16.cu)
    "repro_flash_attention_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # d -> dynamic shared memory per CTA in bytes
    "repro_flash_attention_smem_bytes": (_I,),
    "repro_flash_attention_smem_bytes_bf16": (_I,),
    # d, width, rows_per_cta -> dynamic shared memory per CTA in bytes
    "repro_gram_matvec_smem_bytes": (_I, _I, _I),
    "repro_gram_matvec_smem_bytes_bf16": (_I, _I, _I),
    # d, width, stage2_tc -> dynamic shared memory per CTA in bytes
    "repro_gram_matvec_bwd_smem_bytes": (_I, _I, _I),
    # d, width -> dynamic shared memory per CTA of a bf16 backward in bytes
    "repro_gram_matvec_bwd_smem_bytes_bf16": (_I, _I),
    # d, width -> dynamic shared memory per CTA in bytes
    "repro_rff_matvec_smem_bytes": (_I, _I),
    "repro_rff_matvec_smem_bytes_bf16": (_I, _I),
    # d, width, products_tc -> dynamic shared memory per CTA in bytes
    "repro_rff_bwd_smem_bytes": (_I, _I, _I),
    "repro_rff_bwd_smem_bytes_bf16": (_I, _I),
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # wall time of compiling and linking; 0.0 when reused
    log: str  # nvcc's output, including ``-Xptxas -v``
    ptxas: tuple  # one dict per kernel: name, registers, spills, static smem
    objects: tuple = ()  # one dict per source: source, seconds of its nvcc


_LIB: Optional[ctypes.CDLL] = None
_INFO: Optional[BuildInfo] = None


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the port's CUDA kernels are built from source at first use"
    )


def _kernel_name(mangled: str) -> str:
    """``_ZN…18gram_matvec_kernelILi2ELi72EEEv…`` → ``gram_matvec_kernel<2,72>``
    (a ``bool`` argument, ``Lb1E``, as 1)."""
    m = re.search(r"\d+([a-z_][a-z0-9_]*_kernel)I((?:L[ib]\d+E)+)E", mangled)
    if not m:
        return mangled
    return f"{m.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', m.group(2)))}>"


def parse_ptxas(log: str) -> tuple:
    """Per-kernel registers, spill bytes and static shared memory from
    ``-Xptxas -v`` output."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = dict(name=_kernel_name(m.group(1)), registers=None,
                       spill_stores=0, spill_loads=0, smem_static=0)
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["smem_static"] = int(m.group(1))
    return tuple(out)


def _run(cmd: list) -> tuple:
    """(returncode, output, seconds) of one command."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return proc.returncode, proc.stdout + proc.stderr, time.perf_counter() - t0


def _run_all(cmds: dict) -> dict:
    """Run the commands {key: argv} at once; {key: (returncode, output, seconds)}.
    Returns when every process has ended."""
    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        futures = {k: pool.submit(_run, c) for k, c in cmds.items()}
        return {k: f.result() for k, f in futures.items()}


def build(force: bool = False) -> BuildInfo:
    """Compile every source under ``csrc/`` to its own object (one ``nvcc`` each,
    all at once) and link them into one library.

    Reuses a library built from the same sources and flags unless ``force``.
    Raises ``RuntimeError`` with nvcc's output if the build fails.
    """
    global _INFO
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    path = BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"
    log_path = path.with_suffix(".log")
    if path.exists() and log_path.exists() and not force:
        log = log_path.read_text()
        _INFO = BuildInfo(path=path, seconds=0.0, log=log, ptxas=parse_ptxas(log))
        return _INFO
    # build under private names, then rename: a concurrent build never loads
    # a half-written library
    objdir = BUILD_DIR / f"{path.stem}.{os.getpid()}.obj"
    objdir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    nvcc = _nvcc()
    cus = [src for src in _sources() if src.suffix == ".cu"]
    objs = {src.name: objdir / f"{src.stem}.o" for src in cus}
    t0 = time.perf_counter()
    try:
        done = _run_all({src.name: [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o",
                                    str(objs[src.name])] for src in cus})
        logs = [f"== nvcc {name} ({secs:.1f} s, exit {rc})\n{out}"
                for name, (rc, out, secs) in done.items()]
        failed = [name for name, (rc, _, _) in done.items() if rc != 0]
        if not failed:
            link = [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(o) for o in objs.values())]
            rc, out, _ = _run(link)
            logs.append(f"== link (exit {rc})\n{out}")
            if rc != 0:
                failed = ["link"]
        log = "\n".join(logs)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    log_path.write_text(log)
    os.replace(tmp, path)
    objects = tuple(dict(source=name, seconds=secs)
                    for name, (_, _, secs) in done.items())
    _INFO = BuildInfo(path=path, seconds=seconds, log=log, ptxas=parse_ptxas(log),
                      objects=objects)
    return _INFO


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    if _LIB is None:
        info = _INFO or build()
        lib = ctypes.CDLL(str(info.path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        text = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({text})")
