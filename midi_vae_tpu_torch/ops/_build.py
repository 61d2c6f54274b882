"""Builds the hand-written CUDA kernels with nvcc and loads them with ctypes.

Follows the lazy g++ + ctypes loader of ``midi_vae_tpu/native/__init__.py``:
each ``csrc/<name>.cu`` compiles on first use (or all together through
``build``), with a plain C interface,
into ``midi_vae_tpu_torch/csrc/build/lib<name>.so`` (the ``build/`` pattern of
``.gitignore`` covers it), and is rebuilt when a source under ``csrc/`` is
newer than the library. Nothing here runs at import time: the CPU paths never
build anything, and a missing ``nvcc`` raises only when a CUDA tensor asks for
a kernel.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import re
import shutil
import subprocess
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
# -Xptxas -v only reports each kernel's registers, shared memory and spills
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# every kernel library, one per csrc/<name>.cu
LIBRARIES = ("gru_layer_fwd", "gru_decode", "gru_layer_bwd", "gru_decode_train",
             "gru_decode_bwd", "grad_reduce", "gru_layer_xp_fwd", "gru_layer_xp_bwd",
             "lstm_layer_fwd", "lstm_decode", "lstm_layer_bwd", "lstm_layer_xp_fwd",
             "lstm_layer_xp_bwd", "lstm_step", "gru_step", "gru_encoder_scan",
             "lstm_encoder_scan", "gru_encoder_stack_fwd", "gru_encoder_stack_bwd")
# libraries built from another library's source with extra nvcc flags:
# name -> (source, flags), loaded by chip_smoke.py alone (no wrapper loads
# them): kernel W with one TF32 product instead of three, the control its
# limit must catch
VARIANTS = {"grad_reduce_tf32one": ("grad_reduce", ["-DMVT_W_TF32_ONE"])}
# seconds spent in nvcc by this process, per library (chip_smoke reports it)
build_seconds: dict[str, float] = {}
# per library built by this process: {kernel function (mangled): {"registers",
# "spill_stores", "spill_loads"}}, from ptxas's report
ptxas_report: dict[str, dict[str, dict[str, int]]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "midi_vae_tpu_torch cannot be built"
    )


def _stale(name: str) -> bool:
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    sources = glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh"))
    newest = max(os.path.getmtime(p) for p in sources)
    return not (os.path.exists(so) and os.path.getmtime(so) >= newest)


def build(names) -> None:
    """Build the stale libraries among ``names`` (``LIBRARIES`` and
    ``VARIANTS``), one nvcc process per library, all started together."""
    todo = [n for n in dict.fromkeys(names) if _stale(n)]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    running = []
    for name in todo:
        source, flags = VARIANTS.get(name, (name, []))
        src = os.path.join(CSRC, f"{source}.cu")
        so = os.path.join(BUILD_DIR, f"lib{name}.so")
        # compile to a unique file and rename into place, so a concurrent
        # process never loads a half-written library
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", tmp, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, src, so, tmp, cmd, proc, time.perf_counter()))
    failures = []
    for name, src, so, tmp, cmd, proc, t0 in running:
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            failures.append(f"nvcc failed for {src} (rc {proc.returncode}):\n{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, so)
            ptxas_report[name] = parse_ptxas(out)
    if failures:
        raise RuntimeError("\n".join(failures))


_ENTRY = re.compile(r"(?:Compiling entry function|Function properties for) '?([A-Za-z0-9_]+)'?")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def parse_ptxas(text: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes per kernel from ``nvcc -Xptxas -v`` output."""
    kernels: dict[str, dict[str, int]] = {}
    current = None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = kernels.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = _SPILLS.search(line)
        if m:
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = _REGS.search(line)
        if m:
            current["registers"] = int(m.group(1))
    return {k: v for k, v in kernels.items() if "registers" in v}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if needed."""
    build([name])
    lib = ctypes.CDLL(os.path.join(BUILD_DIR, f"lib{name}.so"))
    lib.mvt_error_string.argtypes = [ctypes.c_int]
    lib.mvt_error_string.restype = ctypes.c_char_p
    return lib


# the dtypes of the kernels with a float32 and a bfloat16 build (load_builds)
DTYPES = (torch.float32, torch.bfloat16)


def load_entry(name: str, entry: str, argtypes) -> tuple:
    """(library, entry point ``entry`` of ``csrc/<name>.cu``), its argument
    types set and returning the CUDA error code."""
    lib = load(name)
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def load_builds(name: str, entry: str, argtypes) -> tuple:
    """(library, {dtype: entry point}) of a kernel with a float32 build
    (``entry``) and a bfloat16 one (``entry_bf16``) in ``csrc/<name>.cu``."""
    fns = {dt: load_entry(name, e, argtypes)[1]
           for dt, e in zip(DTYPES, (entry, f"{entry}_bf16"))}
    return load(name), fns


def count_launch(fn, dtype: torch.dtype, n: int = 1) -> None:
    """``n`` more launches of wrapper ``fn``'s build of ``dtype``:
    ``fn.launches`` (float32) or ``fn.launches_bf16``."""
    if dtype == torch.bfloat16:
        fn.launches_bf16 += n
    else:
        fn.launches += n


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.mvt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
