"""Build and load the CUDA kernels of the port.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``) with
``-fmad=false`` (the rounding contract of ``kernels/ref.py`` places every
FMA by hand) and loaded with ``ctypes``. A library is built at its first
use, from the sources in the checkout, into ``build/repro_torch/`` at the
root of the checkout; its file name carries a hash of the flags, the
kernel's source and every header of ``csrc/``, so an edited source or
header is rebuilt. ``build`` starts one ``nvcc`` per
source, all at once, and waits for them.

Nothing here runs at import: this module is imported on machines with no
``nvcc`` and no card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

from repro_torch.kernels.ref import plane

__all__ = ["KERNELS", "NVCC_FLAGS", "BUILD_DIR", "nvcc_command", "build",
           "function", "on_card", "check", "ptr", "stream", "tile_of",
           "grid_for", "rows_per_item", "lookback_scratch", "keeping_captured",
           "POINT_ARGTYPES", "point_args", "PLANE_ARGTYPES", "plane_args",
           "plane_tensor", "WORKLOAD_ARGTYPES", "workload_args", "UNROLLS",
           "EX_BLOCKS", "unroll_arg", "block_args"]

KERNELS = ("mandelbrot_dwell", "perimeter_query", "region_fill",
           "region_dwell", "olt_compact", "region_dwell_pooled",
           "moe_dispatch")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# loaded libraries and typed launch functions; filled on first use
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, object] = {}
_SMS: Dict[object, int] = {}  # SM count per device index


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built on the machine with the card")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path) -> list:
    """The nvcc command line that builds ``csrc/<name>.cu`` into ``out``."""
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Build the libraries that are missing, one ``nvcc`` per source, all
    started together. Returns ``{name: {"path", "seconds", "log"}}``, with
    ``log`` the compiler's ``-Xptxas -v`` report (empty when the library
    was already built). Raises with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    result = {}
    t0 = time.perf_counter()
    for name in names:
        path = _library_path(name)
        result[name] = {"path": str(path), "seconds": 0.0, "log": ""}
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, path)
    failures = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        result[name]["seconds"] = time.perf_counter() - t0
        result[name]["log"] = log
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (rc={proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)  # atomic: concurrent builds race harmlessly
    if failures:
        raise RuntimeError("\n".join(failures))
    return result


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: Sequence, restype=None):
    """The C launch function ``symbol`` of library ``name``, typed, wrapped
    so that a non-zero ``cudaGetLastError()`` raises ``RuntimeError``. With
    ``restype``, the typed function itself, which launches nothing and
    returns a ``restype``."""
    launch = _FUNCS.get((name, symbol))
    if launch is not None:
        return launch
    lib = _library(name)
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    if restype is not None:
        fn.restype = restype
        _FUNCS[(name, symbol)] = fn
        return fn
    fn.restype = ctypes.c_int

    def launch(*args):
        err = fn(*args)
        if err != 0:
            msg = lib.repro_error_string(err).decode()
            raise RuntimeError(f"{symbol}: CUDA error {err}: {msg}")

    _FUNCS[(name, symbol)] = launch
    return launch


# -- wrapper helpers ---------------------------------------------------------

def on_card(device) -> bool:
    """True for a CUDA device, False for the CPU (the plain versions);
    raises for any other device, and for CUDA when there is no card."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' for the plain versions")
    return True


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype/rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-D {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device: kernels launch there."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def tile_of(side: int, scheme: str, tile: int) -> int:
    """Edge of the square tile that a region is cut into: the whole region
    for SBR (or a region no larger than the tile), ``tile`` for MBR (paper
    Sec. 4.3). A region may hold any number of tiles."""
    if scheme not in ("sbr", "mbr"):
        raise ValueError(f"unknown scheme {scheme!r}")
    if scheme == "sbr" or side <= tile:
        return side
    if side % tile:
        raise ValueError(f"side={side} not divisible by tile={tile}")
    return tile


def grid_for(device, items: int, threads: int) -> int:
    """Blocks of a grid-stride launch: enough to fill every SM of the card
    with ``threads``-thread blocks, and no more than ``items``."""
    dev = torch.device(device)
    sms = _SMS.get(dev.index)
    if sms is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _SMS[dev.index] = sms
    return max(1, min(int(items), sms * (2048 // threads)))


def rows_per_item(side: int) -> int:
    """Canvas rows of one region (or tile) in one item of the region
    kernels (a block's piece in the fill, a warp's in the dwell): the whole
    region up to 4096 pixels, else as many rows as make 4096 pixels (at
    least one)."""
    return max(1, min(side, 4096 // side))


LOOKBACK_STATE = 1  # kState of csrc/lookback.cuh: the ticket counter
_MAX_LOOKBACK_WORDS = 1 << 30  # the epoch tags stay exact below (lookback.cuh)


_KEEPERS: list = []  # the lists of ``keeping_captured`` blocks, innermost last


@contextlib.contextmanager
def keeping_captured():
    """Collect in the list this yields every look-back scratch that a
    capture inside the block uses, for the caller to keep as long as its
    graph (``core.graphs``); such a scratch goes on no kernel's
    ``captured`` list, which a graph captured elsewhere keeps alive for the
    life of the process."""
    keep: list = []
    _KEEPERS.append(keep)
    try:
        yield keep
    finally:
        _KEEPERS.remove(keep)


def lookback_scratch(held: dict, captured: list, device, stream: int,
                     words: int, what: str) -> torch.Tensor:
    """The look-back scratch of a single-pass scan (``csrc/lookback.cuh``)
    on this device and stream, with room for at least ``words`` status
    words after its ``LOOKBACK_STATE`` words. ``held`` maps (device index,
    stream) to the kernel's scratch, one a stream, the largest call's: one
    is made (zeroed) when there is none large enough, at twice the old
    size, and the old one is dropped unless a CUDA graph captured it (a
    graph keeps its pointers): the innermost ``keeping_captured`` block's
    list holds it then, else ``captured``. Under a graph capture none is
    made, as its zeroing would only be recorded: that raises, naming
    ``what``."""
    key = (device.index, stream)
    scratch = held.get(key)
    have = scratch.numel() - LOOKBACK_STATE if scratch is not None else 0
    with torch.cuda.device(device):
        capturing = torch.cuda.is_current_stream_capturing()
    if have < words:
        if capturing:
            raise RuntimeError(
                f"{what}: the capturing stream has {have} look-back words, "
                f"this call needs {words}; make one call of this shape on "
                "that stream before the capture (torch.cuda.stream(s), then "
                "torch.cuda.graph(g, stream=s))")
        size = max(words, 2 * have)
        if size >= _MAX_LOOKBACK_WORDS:
            raise ValueError(f"{size} look-back words: at most "
                             f"{_MAX_LOOKBACK_WORDS - 1}")
        scratch = held[key] = torch.zeros((LOOKBACK_STATE + size,),
                                          dtype=torch.int64, device=device)
    keep = _KEEPERS[-1] if _KEEPERS else captured
    if capturing and not any(scratch is c for c in keep):
        keep.append(scratch)
    return scratch


# the schedules of the escape kernels on the card, the tuned tier's axes:
# steps per block of the escape loop (each library holds an instance of each
# and its launch function picks one; csrc/escape_time.cuh), and Ex's thread
# block, (rows, columns) of threads, one thread per pixel
UNROLLS = (4, 8, 16)
EX_BLOCKS = ((16, 16), (8, 32), (4, 32))


def unroll_arg(unroll) -> int:
    """The launch functions' ``unroll``: 0 (the library's default, the
    ``.cu``'s kUnroll) for None, else one of ``UNROLLS``."""
    if unroll is None:
        return 0
    if int(unroll) not in UNROLLS:
        raise ValueError(f"unroll={unroll}: the card's kernels take "
                         f"{UNROLLS} steps a block (or None, the default)")
    return int(unroll)


def block_args(block) -> list:
    """Ex's (block_rows, block_cols): (0, 0), its default, for None, else
    one of ``EX_BLOCKS``."""
    if block is None:
        return [0, 0]
    block = tuple(int(b) for b in block)
    if block not in EX_BLOCKS:
        raise ValueError(f"block={block}: Ex's thread blocks are {EX_BLOCKS} "
                         "(rows, columns), or None, the default")
    return list(block)


# argtypes of the (max_dwell, kind, c_re, c_im, m) block that every
# escape-time launch function takes
WORKLOAD_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_int]
# ... preceded by (re0, im0, step_re, step_im) where the plane is one value
POINT_ARGTYPES = [ctypes.c_float] * 4 + WORKLOAD_ARGTYPES


def workload_args(max_dwell: int, workload) -> list:
    """The workload as the kernels take it: max_dwell, the spec's kernel id
    and its parameters (None is mandelbrot). A grid workload has no
    escape-time kernel: it raises, as an escape kernel would compute it as
    something else (``ops`` routes such a workload to the plain path)."""
    if workload is not None and getattr(workload, "kind", "escape") != "escape":
        raise ValueError(
            f"workload {workload.name!r} is a {workload.kind} workload: the "
            "escape-time kernels cannot compute it (kernels.ops routes it to "
            "the plain path)")
    kind, (c_re, c_im, m) = ((0, (0.0, 0.0, 0)) if workload is None else
                             (workload.kernel_id, workload.kernel_params))
    return [int(max_dwell), int(kind), float(c_re), float(c_im), int(m)]


def _plane_values(n: int, bounds) -> tuple:
    if n > 1 << 24:
        raise ValueError(f"n={n}: pixel indices must be exact in f32")
    return plane(n, bounds)


def point_args(n: int, bounds, max_dwell: int, workload) -> list:
    """The plane map and the workload as the kernels take them: the exact
    f32 values of ``ref.plane``, then ``workload_args``."""
    return [*_plane_values(n, bounds), *workload_args(max_dwell, workload)]


# ... preceded by a pointer to the plane, [4] f32 on the card, where the
# kernel reads it from memory (the single-frame Q and A)
PLANE_ARGTYPES = [ctypes.c_void_p] + WORKLOAD_ARGTYPES


@functools.lru_cache(maxsize=64)
def _cached_plane(n: int, bounds: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(_plane_values(n, bounds), dtype=torch.float32,
                        device=device)


def plane_tensor(n: int, bounds, device) -> torch.Tensor:
    """The f32 values of ``ref.plane(n, bounds)`` as a [4] tensor on
    ``device``: how the single-frame border query and leaf kernels take
    their window, from memory, so that a CUDA graph of them serves any
    window that is copied in (``FrameProblem.reading``). Made once per
    (n, bounds, device) of the last 64 (tensor bounds: at each call)."""
    device = torch.device(device)
    if isinstance(bounds, torch.Tensor):
        return torch.tensor(_plane_values(n, bounds), dtype=torch.float32,
                            device=device)
    return _cached_plane(n, tuple(float(b) for b in bounds), device)


def plane_args(n: int, bounds, plane_t, max_dwell: int, workload,
               device: torch.device) -> list:
    """``PLANE_ARGTYPES``' values: the pointer of ``plane_t`` (a [4] f32
    tensor on ``device`` holding ``ref.plane(n, bounds)``; None: the one
    ``plane_tensor`` keeps), then ``workload_args``."""
    if plane_t is None:
        plane_t = plane_tensor(n, bounds, device)
    check(plane_t, "plane", torch.float32, 1)
    if plane_t.shape[0] != 4 or plane_t.device != device:
        raise ValueError(f"plane must be [4] on {device}, got "
                         f"{tuple(plane_t.shape)} on {plane_t.device}")
    return [ptr(plane_t), *workload_args(max_dwell, workload)]
