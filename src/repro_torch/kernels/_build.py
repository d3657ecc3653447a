"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and bind them with ctypes.

Each source compiles into a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds, not minutes), at first use, into
``build/repro_torch/`` at the root of the checkout.  The library's file name
carries a hash of its sources and flags, so an edited source never loads a
stale build, and a finished build is moved into place atomically, so
concurrent processes can build the same source safely.

Nothing here runs at import time: this module is imported on machines with
neither ``nvcc`` nor a card, where only the plain PyTorch versions run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

import torch


CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("distance_tile", "distance_tile_counts", "dense_tile", "dense_tile_fused", "flash_attention",
           "flash_attention_wgmma")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_TILE = 128  # tile_eval.cuh, tile_stage.cuh: kMaxT

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# extern "C" signatures of csrc/*.cu; every function returns 0 on success
SIGNATURES = {
    "distance_tile": {
        "distance_tile_counts": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P],
        "distance_tile_mask": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P],
    },
    "distance_tile_counts": {
        "distance_tile_pair_counts": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _P, _I, _P],
        "distance_tile_count_scatter": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _I, _P, _I, _I, _P],
        "distance_tile_pairs_compact": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _I, _I, _P, _P, _P, _I,
                                        _P],
    },
    "dense_tile": {
        "dense_tile_counts": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P],
        "dense_tile_mask": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P],
    },
    "dense_tile_fused": {
        "dense_tile_pair_eval": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _I, _P],
        "dense_tile_count_scatter": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _I, _I, _P],
        "dense_tile_pairs_compact": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _I, _I, _P, _P, _P, _I,
                                     _P],
    },
    "flash_attention": {
        "flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    },
    "flash_attention_wgmma": {
        "flash_attention_wgmma_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine with the card")


def library_path(name: str) -> Path:
    """Where the built library of ``csrc/<name>.cu`` lives (hash of the source,
    the ``csrc/`` headers it includes, and the flags)."""
    src = CSRC / f"{name}.cu"
    text = src.read_bytes()
    headers = sorted(set(re.findall(rb'#include "([^"]+)"', text)))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for part in [text] + [(CSRC / hdr.decode()).read_bytes() for hdr in headers]:
        h.update(part)
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def ptxas_report(name: str) -> str:
    """``nvcc -Xptxas -v`` output of the build (registers, shared memory, spills)."""
    log = library_path(name).with_suffix(".ptxas.txt")
    return log.read_text() if log.exists() else ""


def _start_build(name: str):
    out = library_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish_build(name: str, out: Path, tmp: str, proc) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    out.with_suffix(".ptxas.txt").write_text(log)
    os.replace(tmp, out)


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Build every missing library, one ``nvcc`` per source, all at once."""
    started = [(n, *_start_build(n)) for n in names if not library_path(n).exists()]
    for name, out, tmp, proc in started:
        _finish_build(name, out, tmp, proc)


def function(name: str, symbol: str):
    """The ctypes function ``symbol`` of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for sym, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return getattr(lib, symbol)


def check_tile_args(tiles, tile_len, pair_a, pair_b) -> None:
    """Validate what a tile kernel reads before its pointers are passed on."""
    if tiles.dim() != 3 or tiles.dtype != torch.float32:
        raise ValueError(f"tiles must be (num_tiles, T, n_pad) float32, got {tuple(tiles.shape)} {tiles.dtype}")
    t = tiles.shape[1]
    if not 1 <= t <= MAX_TILE:
        raise ValueError(f"the CUDA tile kernels take tile sizes 1..{MAX_TILE}, got T={t}")
    for arg, what in ((tile_len, "tile_len"), (pair_a, "pair_a"), (pair_b, "pair_b")):
        if arg.dtype != torch.int32 or arg.dim() != 1:
            raise ValueError(f"{what} must be a 1-D int32 tensor, got {arg.dtype} {tuple(arg.shape)}")
    if tile_len.shape[0] != tiles.shape[0] or pair_a.shape != pair_b.shape:
        raise ValueError("tile_len must match tiles, and pair_a must match pair_b")
    for arg in (tiles, tile_len, pair_a, pair_b):
        if arg.device != tiles.device or not arg.is_contiguous():
            raise ValueError("tile kernel inputs must be contiguous and on one CUDA device")


def launch_tile_kernel(source, symbol, tiles, tile_len, pair_a, pair_b, eps2, dim_block, outs):
    """Launch ``symbol`` of ``csrc/<source>.cu`` on the current stream.

    ``outs`` are the preallocated output tensors, in the C signature's
    order.  Raises if the launch was refused (``cudaGetLastError() != 0``).
    """
    check_tile_args(tiles, tile_len, pair_a, pair_b)
    fn = function(source, symbol)
    with torch.cuda.device(tiles.device):
        err = fn(
            tiles.data_ptr(), tile_len.data_ptr(), pair_a.data_ptr(), pair_b.data_ptr(),
            pair_a.shape[0], tiles.shape[1], tiles.shape[2], dim_block, eps2,
            *[o.data_ptr() for o in outs],
            torch.cuda.current_stream(tiles.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed with cudaError {err}")


def launch_flash_attention(q, k, v, out, scale, causal) -> None:
    """Launch ``flash_attention_fwd`` of ``csrc/flash_attention.cu`` on the
    current stream; the caller has checked the tensors (``flash_attention.py``).
    Raises if the launch was refused (``cudaGetLastError() != 0``)."""
    bh, sq, dh = q.shape
    sk, dv = v.shape[1], v.shape[2]
    fn = function("flash_attention", "flash_attention_fwd")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, sq, sk, dh, dv, scale, int(causal), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd: CUDA launch failed with cudaError {err}")


def launch_flash_attention_wgmma(q, k, v, out, scale, causal) -> None:
    """Launch ``flash_attention_wgmma_fwd`` of ``csrc/flash_attention_wgmma.cu``
    on the current stream; the caller has checked the tensors
    (``flash_attention.py``).  Raises if the launcher returns non-zero: a
    refused launch (``cudaGetLastError()``), or a tensor map libcuda would
    not encode (-1: no encoder; -1000 - CUresult: refused, e.g. data not
    16-byte aligned)."""
    bh, sq, dh = q.shape
    sk, dv = v.shape[1], v.shape[2]
    fn = function("flash_attention_wgmma", "flash_attention_wgmma_fwd")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, sq, sk, dh, dv, scale, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_wgmma_fwd failed with code {err} "
                           "(>0: cudaError; -1: no tensor-map encoder; -1000 - n: CUresult n)")
