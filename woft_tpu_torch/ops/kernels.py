"""Build, bind and launch the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` at the repository
root (a content-hashed file name, so an edited source rebuilds) and loaded
with ``ctypes``. ``build()`` starts one ``nvcc`` per source, all together.

The launch wrappers below take CUDA tensors only (all but L's, below):
they check device, dtype,
shape and contiguity, allocate the output with ``torch.empty``, launch on
the current stream, raise if the C entry reports a CUDA error, and count
their launches in a plain integer attribute (``<wrapper>.launches``;
``launch_counters()`` reads them all). The
callers (``ops/warp.py:warp_perspective_fast``, ``models/corr.py``:
``corr_lookup``, ``block_local_corr``, ``block_local_lookup*``,
``corr_lookup_alternate_levels``;
``models/update.py``: ``gru_update``, ``gru_update_f32``,
``motion_encoder_tail``, ``flow_head``; ``models/weight_head.py``:
``weight_head``; ``models/gma.py``: ``gma_aggregate``; ``ops/sampling.py``:
``masked_sobol_gather``)
take the plain PyTorch version for CPU tensors; a CUDA tensor always goes to
the kernel. L's wrapper (``instance_norm_act``, the encoders' caller in
``models/raft.py``) makes that choice itself: a CPU tensor takes
``instance_norm_act_plain``, in this module. Under grad, B, C, D, E and K
are reached through ``torch.autograd.Function``s (``models/corr.py``: B's
backward is kernel B', C's, D's, E's and K's the VJPs of their plain
versions, as in the JAX package); A, F, G, H, I, J, L and M have no backward,
and their callers raise (``require_no_grad``) rather than return an output
with no graph. N's outputs are integer indices and flags, which carry no
gradient.

| kernel | source | TPU kernel it replaces |
|---|---|---|
| A ``warp_perspective_bilinear`` | ``csrc/warp.cu`` | ``ops/pallas/warp.py:block_warp`` |
| B ``corr_pyramid_lookup`` (float32 or bf16 levels) | ``csrc/corr_lookup.cu`` | ``ops/pallas/corr_lookup.py:fused_corr_lookup`` |
| B' ``corr_pyramid_lookup_backward`` (B's backward, training) | ``csrc/corr_lookup.cu`` | none: the JAX package differentiates its XLA lookup |
| C ``local_corr_build`` | ``csrc/local_corr.cu`` | ``ops/pallas/local_corr.py:block_local_corr`` |
| D ``local_lookup_coords`` (from coordinates), ``local_lookup_fine_multi`` (explicit operands) | ``csrc/local_lookup.cu`` | ``ops/pallas/local_lookup.py:block_local_lookup_fine_multi`` |
| E ``local_lookup_exact_coords`` (from coordinates), ``local_lookup_exact`` (explicit starts) | ``csrc/local_lookup.cu`` | ``ops/pallas/local_lookup.py:block_local_lookup`` |
| F ``local_lookup_fine`` | ``csrc/local_lookup.cu`` | ``ops/pallas/local_lookup.py:block_local_lookup_fine`` |
| G ``fused_gru_update`` | ``csrc/gru.cu`` | ``ops/pallas/gru.py:fused_gru_update`` |
| G's float32 form ``fused_gru_update_f32`` (the canonical float32 path) | ``csrc/gru_f32.cu`` | none: the JAX package runs its float32 GRU through XLA |
| H ``motion_encoder_tail`` | ``csrc/update_tail.cu`` | ``ops/pallas/update_tail.py:motion_encoder_pallas`` |
| I ``flow_head`` | ``csrc/flow_head.cu`` | ``ops/pallas/update_tail.py:flow_head_pallas`` |
| J ``weight_head`` (the bf16 weight head) | ``csrc/weight_head.cu`` | none: the JAX package runs its weight head through XLA |
| K ``alt_corr_lookup`` (the volume-free lookup, ``alternate_corr``) | ``csrc/alt_corr.cu`` | none: the JAX package gathers its alternate lookup through XLA |
| L ``instance_norm_act`` (the feature encoder's norms, fused with the ReLU and the residual add) | ``csrc/instance_norm.cu`` | none: the JAX package runs its instance norm through XLA |
| M ``gma_aggregate`` (GMA's global motion aggregation, ``models/gma.py``) | ``csrc/gma_aggregate.cu`` | none: the JAX package has no GMA |
| N ``masked_sobol_select`` (the trackers' Sobol-n selection of TCs, two launches: tile counts, then one warp a target) | ``csrc/sobol_select.cu`` | none: the JAX package selects through XLA (``woft_tpu/ops/sampling.py:masked_sobol_gather``) |

G's float32 form is float32 FFMA (no tensor cores) and shares no kernel
body with G. G, H, I and J share ``csrc/conv_wgmma.cuh`` (a convolution as per-tap
``wgmma`` products, the taps brought in by TMA; the C entries encode the
taps' tensor maps at the first call with a pointer and keep them); every
``csrc/*.cuh`` enters each library's content hash.
"""

import contextlib
import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("warp", "corr_lookup", "local_corr", "local_lookup", "gru",
           "gru_f32", "update_tail", "flow_head", "weight_head", "alt_corr",
           "instance_norm", "gma_aggregate", "sobol_select")
# --fmad=false: no FMA contraction, so the kernels round like their plain
# PyTorch versions (see the notes at the top of each source)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# source -> {C symbol: argument types}
_ENTRIES = {
    "warp": {"woft_warp_bilinear": [_P, _I, _I, _I, _I, _I, _P, _P, _I, _I,
                                    _P]},
    "corr_lookup": {
        "woft_corr_lookup": [_P, _P, _P, _I, _P, _P, ctypes.c_longlong, _I,
                             _P, _P],
        "woft_corr_lookup_bf16": [_P, _P, _P, _I, _P, _P, ctypes.c_longlong,
                                  _I, _P, _P],
        "woft_corr_lookup_backward": [_P, _P, _P, _P, _I, _P, _P,
                                      ctypes.c_longlong, _I, _P, _P],
        "woft_corr_lookup_backward_bf16": [_P, _P, _P, _P, _I, _P, _P,
                                           ctypes.c_longlong, _I, _P, _P],
    },
    "local_corr": {
        "woft_local_corr_plan": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 ctypes.c_float, _I, _P],
        "woft_local_corr_launch": [_P, _P],
        "woft_local_corr_params_size": [],
    },
    "local_lookup": {
        "woft_local_lookup_coords": [_P, _P, _I, _P, _P, _I, _I, _I, _I,
                                     _I, _P, _I, _P, _P],
        "woft_local_lookup_exact_coords": [_P, _P, _I, _P, _P, _P, _I, _I,
                                           _I, _I, _I, _P, _I, _P],
        "woft_local_lookup_fine_multi": [_P, _P, _P, _I, _P, _P, _P, _I, _I,
                                         _I, _I, _P, _I, _P],
        "woft_local_lookup_fine": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                                   _P, _I, _P],
        "woft_local_lookup_exact": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I,
                                    _I, _P, _I, _I, _I, _P],
    },
    "gru": {"woft_gru_update": [_P] * 9 + [_I] * 5 + [_P]},
    "gru_f32": {"woft_gru_update_f32": [_P] * 7 + [_I] * 5 + [_P]},
    "update_tail": {"woft_motion_encoder_tail": [_P] * 11 + [_I, _I, _P]},
    "flow_head": {"woft_flow_head": [_P] * 6 + [_I, _I, _P]},
    "weight_head": {"woft_weight_head": [_P, _I, _P, _P, _P, _P, _I, _P]},
    "alt_corr": {"woft_alt_corr": [_P, _P, _P, _I, _P, _P, _P,
                                   ctypes.c_longlong, _I, _I, _I, _I, _I, _P,
                                   _P]},
    "instance_norm": {
        "woft_instance_norm": [_P] * 4 + [_I] * 8
        + [ctypes.c_float, _P, _P, _P],
        "woft_instance_norm_nhwc": [_P, _P] + [_I] * 6
        + [ctypes.c_float, _P, _P, _P, _P]},
    "gma_aggregate": {"woft_gma_aggregate": [_P, _I, _P, _I, _P, _P, _P, _I,
                                             _P]},
    "sobol_select": {"woft_sobol_select": [_P, _P] + [_I] * 6
                     + [_P, _P, _P, _P]},
}
_entries = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name):
    """Content-hashed shared-library path of ``csrc/<name>.cu``."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=SOURCES):
    """Compile the sources whose library is missing, one ``nvcc`` per source,
    all started together. Returns ``{name: nvcc/ptxas report}`` for the ones
    compiled; raises with the compiler output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} ---\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def _entry(name, symbol=None):
    """The C entry ``symbol`` of ``csrc/<name>.cu`` (its only one when
    ``symbol`` is None), building and loading the library at first use."""
    symbol = symbol or next(iter(_ENTRIES[name]))
    fn = _entries.get(symbol)
    if fn is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for sym, argtypes in _ENTRIES[name].items():
            f = getattr(lib, sym)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _entries[sym] = f
        fn = _entries[symbol]
    return fn


def _check_tensor(t, what, dtype, device):
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


_ALREADY_CURRENT = contextlib.nullcontext()


def _current(device):
    """Context that makes ``device`` the current CUDA device for a launch;
    free when it already is (the wrappers run ~80 times a frame)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return _ALREADY_CURRENT
    return torch.cuda.device(device)


def _stream():
    """Handle of the current device's current stream. The raw getter skips
    building a ``torch.cuda.Stream`` object per launch."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(torch.cuda.current_device())
    return torch.cuda.current_stream().cuda_stream


def require_no_grad(kernel, *tensors):
    """Raise when autograd would record one of ``tensors`` through
    ``kernel``, a kernel with no backward (A, F, G, H, I, J; none has one in
    the JAX package either): its output would carry no graph, and the
    gradient would be lost without an error. Checked before the device
    dispatch, so the CPU path refuses the same calls."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"kernel {kernel} has no backward: call it under "
            f"torch.no_grad(), or on tensors that do not require grad")


_COUNTED = []


def _counted(wrapper):
    """Registers a launch wrapper: ``wrapper.launches`` counts its launches
    (the wrapper adds each one)."""
    wrapper.launches = 0
    _COUNTED.append(wrapper)
    return wrapper


def launch_counters():
    """{wrapper: its launches so far} for every launch wrapper below."""
    return {wrapper: wrapper.launches for wrapper in _COUNTED}


def _raise_on_error(rc, name):
    if rc >= 20000:
        raise RuntimeError(f"CUDA kernel '{name}': the driver has no "
                           f"cuTensorMapEncodeTiled")
    if rc >= 10000:
        raise RuntimeError(f"CUDA kernel '{name}': cuTensorMapEncodeTiled "
                           f"failed with CUresult {rc - 10000}")
    if rc != 0:
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: "
                           f"cudaError {rc}")


@_counted
def warp_perspective_bilinear(img, hinv, out_h, out_w):
    """Kernel A: bilinear perspective warp with zero padding.

    img: (N, H, W, C) float32 CUDA, or (1, H, W, C): one source warped by
    each of the N homographies; hinv: (N, 3, 3) float32 inverse
    homographies (dst -> src). Returns (N, out_h, out_w, C) float32 with
    out[n](x, y) = img[n or 0](hinv[n] (x, y)), the pixel centre
    back-projected."""
    if img.device.type != "cuda":
        raise ValueError("warp_perspective_bilinear takes CUDA tensors")
    _check_tensor(img, "img", torch.float32, img.device)
    _check_tensor(hinv, "hinv", torch.float32, img.device)
    if img.dim() != 4 or min(img.shape) == 0:
        raise ValueError(f"img must be a non-empty (N, H, W, C), got "
                         f"{tuple(img.shape)}")
    src_n, H, W, C = img.shape
    N = hinv.shape[0] if hinv.dim() == 3 else -1
    if hinv.shape != (N, 3, 3) or src_n not in (1, N):
        raise ValueError(f"hinv must be (N, 3, 3) for a source batch of 1 "
                         f"or N, got {tuple(hinv.shape)} for {src_n}")
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"bad output size {out_h}x{out_w}")
    if max(img.numel(), N * out_h * out_w * C) >= 2 ** 31:
        raise ValueError("the kernel indexes with 32 bits: source and "
                         "output must each hold fewer than 2^31 elements")
    out = torch.empty((N, out_h, out_w, C), dtype=torch.float32,
                      device=img.device)
    fn = _entry("warp")
    with _current(img.device):
        rc = fn(img.data_ptr(), src_n, N, H, W, C, hinv.data_ptr(),
                out.data_ptr(), out_h, out_w, _stream())
    _raise_on_error(rc, "warp")
    warp_perspective_bilinear.launches += 1
    return out


_level_table = [None, None]     # key and table of the pyramid last looked up


_LEVEL_DTYPES = (torch.float32, torch.bfloat16)


def _levels(pyramid, device):
    """The checked level table of a pyramid: ``ctypes`` arrays of pointers,
    heights and widths, and the row count R. It is built once a pyramid and
    serves the 13 lookups of a flow; the key holds everything the checks
    read, so a hit repeats none of them."""
    key = tuple((p.data_ptr(), p.shape, p.stride(), p.dtype, p.device)
                for p in pyramid)
    if _level_table[0] != key:
        L = len(pyramid)
        if not 1 <= L <= 8:
            raise ValueError(f"1 to 8 pyramid levels, got {L}")
        R = pyramid[0].shape[0]
        dtype = pyramid[0].dtype
        if dtype not in _LEVEL_DTYPES:
            raise TypeError(f"pyramid levels must be float32 or bfloat16, "
                            f"got {dtype}")
        for lvl, p in enumerate(pyramid):
            _check_tensor(p, f"pyramid[{lvl}]", dtype, device)
            if p.dim() != 3 or p.shape[0] != R or min(p.shape) == 0:
                raise ValueError(f"pyramid[{lvl}] must be a non-empty ({R}, "
                                 f"Hl, Wl), got {tuple(p.shape)}")
        _level_table[:] = key, (
            (ctypes.c_void_p * L)(*[p.data_ptr() for p in pyramid]),
            (ctypes.c_int * L)(*[p.shape[1] for p in pyramid]),
            (ctypes.c_int * L)(*[p.shape[2] for p in pyramid]), R)
    elif pyramid[0].device != device:
        raise ValueError(f"pyramid is on {pyramid[0].device}, expected "
                         f"{device}")
    return _level_table[1]


@_counted
def corr_pyramid_lookup(pyramid, coords, radius, rows=None):
    """Kernel B: bilinear (2r+1)^2 window lookup in every pyramid level.

    pyramid: list of (R, Hl, Wl) CUDA levels, all float32 or all bfloat16
    (widened to float32 as they are read); coords: (..., 2) float32
    level-0 (x, y), Q points; radius 0 to 8; rows: None (query q reads row
    q, so R == Q) or (Q,) int64 pyramid rows in [0, R). Returns (Q,
    L*(2r+1)^2) float32, channel l*(2r+1)^2 + i*(2r+1) + j sampling level
    l at (x/2^l + i - r, y/2^l + j - r)."""
    if coords.device.type != "cuda":
        raise ValueError("corr_pyramid_lookup takes CUDA tensors")
    device = coords.device
    _check_tensor(coords, "coords", torch.float32, device)
    if not 0 <= radius <= 8:
        raise ValueError(f"radius 0 to 8, got {radius}")
    if coords.shape[-1] != 2 or coords.numel() == 0:
        raise ValueError(f"coords must be a non-empty (..., 2), got "
                         f"{tuple(coords.shape)}")
    Q = coords.numel() // 2
    ptrs, hs, ws, R = _levels(pyramid, device)
    L = len(pyramid)
    if rows is None:
        if R != Q:
            raise ValueError(f"{Q} queries need {Q} pyramid rows, got {R}")
    else:
        _check_tensor(rows, "rows", torch.int64, device)
        if rows.shape != (Q,):
            raise ValueError(f"rows must be ({Q},), got {tuple(rows.shape)}")
    k = 2 * radius + 1
    out = torch.empty((Q, L * k * k), dtype=torch.float32, device=device)
    fn = _entry("corr_lookup", "woft_corr_lookup_bf16"
                if pyramid[0].dtype == torch.bfloat16 else None)
    with _current(device):
        rc = fn(ctypes.addressof(ptrs), ctypes.addressof(hs),
                ctypes.addressof(ws), L, coords.data_ptr(),
                None if rows is None else rows.data_ptr(), Q, radius,
                out.data_ptr(), _stream())
    _raise_on_error(rc, "corr_lookup")
    corr_pyramid_lookup.launches += 1
    return out


@_counted
def corr_pyramid_lookup_backward(pyramid, coords, g, radius):
    """Kernel B': the backward of ``corr_pyramid_lookup`` with rows = query.

    pyramid, coords, radius as the forward's (R == Q); g: (Q, L*(2r+1)^2)
    float32, the gradient of its output. Returns (d_levels, one (Q, Hl, Wl)
    a level in the level's dtype, every element written; d_coords (Q, 2)
    float32): the VJP of the plain lookup, each level's gradient summed in
    float32 and rounded once, the coordinates' summed level by level."""
    if coords.device.type != "cuda":
        raise ValueError("corr_pyramid_lookup_backward takes CUDA tensors")
    device = coords.device
    _check_tensor(coords, "coords", torch.float32, device)
    _check_tensor(g, "g", torch.float32, device)
    if not 0 <= radius <= 8:
        raise ValueError(f"radius 0 to 8, got {radius}")
    Q = coords.numel() // 2
    ptrs, hs, ws, R = _levels(pyramid, device)
    L = len(pyramid)
    k = 2 * radius + 1
    if coords.shape[-1] != 2 or Q == 0 or R != Q:
        raise ValueError(f"coords must be (..., 2) with one point a pyramid "
                         f"row ({R}), got {tuple(coords.shape)}")
    if g.shape != (Q, L * k * k):
        raise ValueError(f"g must be ({Q}, {L * k * k}), got "
                         f"{tuple(g.shape)}")
    d_levels = [torch.empty_like(p) for p in pyramid]
    d_ptrs = (ctypes.c_void_p * L)(*[d.data_ptr() for d in d_levels])
    d_coords = torch.empty((Q, 2), dtype=torch.float32, device=device)
    fn = _entry("corr_lookup", "woft_corr_lookup_backward_bf16"
                if pyramid[0].dtype == torch.bfloat16
                else "woft_corr_lookup_backward")
    with _current(device):
        rc = fn(ctypes.addressof(ptrs), ctypes.addressof(d_ptrs),
                ctypes.addressof(hs), ctypes.addressof(ws), L,
                coords.data_ptr(), g.data_ptr(), Q, radius,
                d_coords.data_ptr(), _stream())
    _raise_on_error(rc, "corr_lookup_backward")
    corr_pyramid_lookup_backward.launches += 1
    return d_levels, d_coords


@_counted
def alt_corr_lookup(f1, levels, coords, radius, cells=None):
    """Kernel K: the alternate (volume-free) lookup, every level in one
    launch.

    f1: (B, H1, W1, D) float32 CUDA query features, D a multiple of 8;
    levels: list of (B, Hl, Wl, D) float32 levels (fmap2 average-pooled l
    times, ``models/corr.py:alternate_levels``; Hl or Wl may be 0); coords:
    (B, H1, W1, 2) float32 level-0 (x, y); radius 3 or 4; cells: None
    (every query, output row q) or (M,) int64 cells ``b*H1*W1 + cell``
    (output row m looks up cell cells[m]; the sparse weight head's rows).
    Returns (B*H1*W1 or M, L*(2r+1)^2) float32, the dense lookup's channel
    order: ``models/corr.py:corr_lookup_alternate_plain``'s function, its
    tap sums in another order."""
    device = coords.device
    if device.type != "cuda":
        raise ValueError("alt_corr_lookup takes CUDA tensors")
    _check_tensor(f1, "f1", torch.float32, device)
    _check_tensor(coords, "coords", torch.float32, device)
    if radius not in (3, 4):
        raise ValueError(f"kernel K takes radius 3 or 4, got {radius}")
    if f1.dim() != 4 or min(f1.shape) == 0 or f1.shape[3] % 8:
        raise ValueError(f"f1 must be a non-empty (B, H1, W1, D) with D a "
                         f"multiple of 8, got {tuple(f1.shape)}")
    B, H1, W1, D = f1.shape
    if coords.shape != (B, H1, W1, 2):
        raise ValueError(f"coords must be {(B, H1, W1, 2)}, got "
                         f"{tuple(coords.shape)}")
    L = len(levels)
    if not 1 <= L <= 8:
        raise ValueError(f"1 to 8 levels, got {L}")
    for lvl, p in enumerate(levels):
        _check_tensor(p, f"levels[{lvl}]", torch.float32, device)
        if p.dim() != 4 or p.shape[0] != B or p.shape[3] != D:
            raise ValueError(f"levels[{lvl}] must be ({B}, Hl, Wl, {D}), got "
                             f"{tuple(p.shape)}")
    n = B * H1 * W1
    if n >= 2 ** 31:
        raise ValueError("kernel K indexes queries with 32 bits")
    if cells is not None:
        _check_tensor(cells, "cells", torch.int64, device)
        if cells.dim() != 1 or cells.shape[0] == 0:
            raise ValueError(f"cells must be a non-empty (M,), got "
                             f"{tuple(cells.shape)}")
        n = cells.shape[0]
    k = 2 * radius + 1
    out = torch.empty((n, L * k * k), dtype=torch.float32, device=device)
    ptrs = (ctypes.c_void_p * L)(*[p.data_ptr() for p in levels])
    hs = (ctypes.c_int * L)(*[p.shape[1] for p in levels])
    ws = (ctypes.c_int * L)(*[p.shape[2] for p in levels])
    fn = _entry("alt_corr")
    with _current(device):
        rc = fn(ctypes.addressof(ptrs), ctypes.addressof(hs),
                ctypes.addressof(ws), L, f1.data_ptr(), coords.data_ptr(),
                None if cells is None else cells.data_ptr(), n, B, H1, W1, D,
                radius, out.data_ptr(), _stream())
    _raise_on_error(rc, "alt_corr")
    alt_corr_lookup.launches += 1
    return out


_VOLUME_DTYPES = (torch.float32, torch.bfloat16)


def local_corr_table(level_shapes, geoms):
    """Kernel C's level table, one row a level as the launch takes it: (hl,
    wl, pad, sh, sw, wh, ww, rows a tile, tiles). The bf16 kernel tiles a
    window in whole rows, at most 128 positions: tile t holds positions
    ``t*rows*ww .. (t+1)*rows*ww - 1`` (the last tile's rows beyond ``wh``
    are computed, not stored). The CTA of query block b = by*nbw + bx reads
    tile t of level l as the TMA box of ``rows`` window rows from level row
    ``by*sh - pad + t*rows`` and column ``(bx*sw)//8*8 - pad``, all ``ww``
    columns, zero outside the level."""
    table = []
    for (hl, wl), (pad, sh, sw, wh, ww) in zip(level_shapes, geoms):
        if not 1 <= ww <= 128 or wh < 1:
            raise ValueError(f"kernel C tiles windows of 1 to 128 columns, "
                             f"got {wh}x{ww}")
        rows = 128 // ww
        table.append((hl, wl, pad, sh, sw, wh, ww, rows, -(-wh // rows)))
    return table


_corr_plan = [None, None]       # key and parameter block of the last launch


@_counted
def local_corr_build(f1b, levels, geoms, nbh, nbw, out_dtype, b0=0):
    """Kernel C: every level of the block-local correlation volume in one
    launch.

    f1b: (nb, 128, D) blocked query features of blocks ``b0 .. b0 + nb -
    1`` of the nbh x nbw grid (the whole grid: b0 = 0, nb = nbh*nbw; a
    band: the spatially sharded forward's share); levels: L (hl, wl, D)
    unpadded target features; all CUDA, contiguous, of ``out_dtype``
    (float32 or bfloat16); D a multiple of 64 up to 256 in bfloat16, of 32
    in float32. geoms: per level (pad, sh, sw, wh, ww), the ``_local_layout``
    entries; ww at most 128. Returns L (nb, wh, ww, 128) volumes:
    ``<f1b[b, q], win_b[py, px]> / sqrt(D)`` with win_b the (wh, ww) window
    at (by*sh - pad, (bx*sw)//8*8 - pad) of the level, zero outside it, (by,
    bx) the grid position of block b0 + b; float32 accumulation, rounded
    once. The parameter block (tensor maps in bfloat16) is kept for the
    pointers, shapes and band of the last call."""
    if f1b.device.type != "cuda":
        raise ValueError("local_corr_build takes CUDA tensors")
    if out_dtype not in _VOLUME_DTYPES:
        raise TypeError(f"volume dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    device = f1b.device
    bf16 = out_dtype == torch.bfloat16
    _check_tensor(f1b, "f1b", out_dtype, device)
    L = len(levels)
    if not 1 <= L <= 8 or len(geoms) != L:
        raise ValueError(f"1 to 8 levels with one geometry each, got {L} "
                         f"and {len(geoms)}")
    nb = f1b.shape[0] if f1b.dim() == 3 else 0
    if (f1b.dim() != 3 or f1b.shape[1] != 128 or nb < 1 or b0 < 0
            or b0 + nb > nbh * nbw):
        raise ValueError(f"f1b must be (nb, 128, D) for blocks {b0} .. "
                         f"{b0} + nb - 1 of {nbh * nbw}, got "
                         f"{tuple(f1b.shape)}")
    D = f1b.shape[2]
    if (D % 64 or D > 256) if bf16 else D % 32:
        raise ValueError(f"D must be a multiple of {64 if bf16 else 32}"
                         f"{' up to 256' if bf16 else ''}, got {D}")
    for lvl, (lv, (pad, sh, sw, wh, ww)) in enumerate(zip(levels, geoms)):
        _check_tensor(lv, f"levels[{lvl}]", out_dtype, device)
        if lv.dim() != 3 or lv.shape[2] != D or min(lv.shape) == 0:
            raise ValueError(f"levels[{lvl}] must be a non-empty (hl, wl, "
                             f"{D}), got {tuple(lv.shape)}")
        if min(nbh, nbw, wh) < 1 or min(pad, sh, sw) < 0:
            raise ValueError("bad block-local geometry")
    table = local_corr_table([lv.shape[:2] for lv in levels], geoms)
    if f1b.data_ptr() % 16 or any(lv.data_ptr() % 16 for lv in levels):
        raise ValueError("f1b and the levels must be 16-byte aligned")
    outs = [torch.empty((nb, g[5], g[6], 128), dtype=out_dtype, device=device)
            for g in table]
    key = (f1b.data_ptr(), D, tuple(lv.data_ptr() for lv in levels),
           tuple(o.data_ptr() for o in outs), tuple(table), nbw, b0, bf16)
    if _corr_plan[0] != key:
        size = _entry("local_corr", "woft_local_corr_params_size")()
        params = ctypes.create_string_buffer(size)
        lv_ptrs = (ctypes.c_void_p * L)(*[lv.data_ptr() for lv in levels])
        out_ptrs = (ctypes.c_void_p * L)(*[o.data_ptr() for o in outs])
        geo = (ctypes.c_int * (9 * L))(*[v for g in table for v in g])
        rc = _entry("local_corr", "woft_local_corr_plan")(
            f1b.data_ptr(), ctypes.addressof(lv_ptrs),
            ctypes.addressof(out_ptrs), ctypes.addressof(geo), L, nb, nbw, b0,
            D, 1.0 / math.sqrt(D), int(bf16), ctypes.addressof(params))
        _raise_on_error(rc, "local_corr")
        _corr_plan[:] = key, params
    fn = _entry("local_corr", "woft_local_corr_launch")
    with _current(device):
        rc = fn(ctypes.addressof(_corr_plan[1]), _stream())
    _raise_on_error(rc, "local_corr")
    local_corr_build.launches += 1
    return outs


def _check_volumes(vols, k):
    """Shared checks of the lookup wrappers -> (device, dtype, nb, bq)."""
    device, dtype = vols[0].device, vols[0].dtype
    if device.type != "cuda":
        raise ValueError("the block-local lookups take CUDA tensors")
    if dtype not in _VOLUME_DTYPES:
        raise TypeError(f"volumes must be float32 or bfloat16, got {dtype}")
    nb, bq = vols[0].shape[0], vols[0].shape[-1]
    for lvl, v in enumerate(vols):
        _check_tensor(v, f"vols[{lvl}]", dtype, device)
        if (v.dim() != 4 or v.shape[0] != nb or v.shape[3] != bq
                or min(v.shape) == 0 or min(v.shape[1:3]) < k + 1):
            raise ValueError(f"vols[{lvl}] must be ({nb}, wh > {k}, ww > "
                             f"{k}, {bq}), got {tuple(v.shape)}")
    return device, dtype, nb, bq


def _check_staged(vols):
    """Kernels D and F stage 16 queries (32 or 64 bytes) of each window
    position with 16-byte copies."""
    if vols[0].shape[3] % 16:
        raise ValueError(f"kernels D and F take a multiple of 16 queries a "
                         f"block, got {vols[0].shape[3]}")
    if any(v.data_ptr() % 16 for v in vols):
        raise ValueError("the volumes must be 16-byte aligned")


def _check_starts(starts, frac, shape, device):
    _check_tensor(starts, "starts", torch.int32, device)
    _check_tensor(frac, "frac", torch.float32, device)
    if tuple(starts.shape) != shape or tuple(frac.shape) != shape:
        raise ValueError(f"starts and frac must be {shape}, got "
                         f"{tuple(starts.shape)} and {tuple(frac.shape)}")


@_counted
def local_lookup_fine_multi(rcs, vols, rel, frac, k, out_dtype=torch.float32):
    """Kernel D: every level's fine-window lookup in one launch.

    rcs: (NB, L, 2) int32 anchors [r0, c0]; vols: L (NB, wh, ww, BQ) CUDA
    volumes of one dtype; rel: (L, 2, NB, BQ) int32 starts relative to the
    anchors ([l, 0] rows, [l, 1] columns); frac: (L, 2, NB, BQ) float32.
    Returns (NB, L*k*k, BQ) ``out_dtype``, channel l*k*k + j*k + i."""
    device, dtype, nb, bq = _check_volumes(vols, k)
    L = len(vols)
    if not 1 <= L <= 8:
        raise ValueError(f"1 to 8 levels, got {L}")
    if out_dtype not in _VOLUME_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    _check_tensor(rcs, "rcs", torch.int32, device)
    if tuple(rcs.shape) != (nb, L, 2):
        raise ValueError(f"rcs must be ({nb}, {L}, 2), got "
                         f"{tuple(rcs.shape)}")
    _check_starts(rel, frac, (L, 2, nb, bq), device)
    _check_staged(vols)
    out = torch.empty((nb, L * k * k, bq), dtype=out_dtype, device=device)
    ptrs = (ctypes.c_void_p * L)(*[v.data_ptr() for v in vols])
    whs = (ctypes.c_int * L)(*[v.shape[1] for v in vols])
    wws = (ctypes.c_int * L)(*[v.shape[2] for v in vols])
    fn = _entry("local_lookup", "woft_local_lookup_fine_multi")
    with _current(device):
        rc = fn(ctypes.addressof(ptrs), ctypes.addressof(whs),
                ctypes.addressof(wws), L, rcs.data_ptr(), rel.data_ptr(),
                frac.data_ptr(), nb, bq, k, int(dtype == torch.bfloat16),
                out.data_ptr(), int(out_dtype == torch.bfloat16),
                _stream())
    _raise_on_error(rc, "local_lookup_fine_multi")
    local_lookup_fine_multi.launches += 1
    return out


@_counted
def local_lookup_fine(rc0, vol, rel, frac, k, out_dtype=torch.float32):
    """Kernel F: kernel D for one level. rc0: (NB, 2) int32; vol: (NB, wh,
    ww, BQ); rel, frac: (2, NB, BQ). Returns (NB, k*k, BQ)."""
    device, dtype, nb, bq = _check_volumes([vol], k)
    if out_dtype not in _VOLUME_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    _check_tensor(rc0, "rc0", torch.int32, device)
    if tuple(rc0.shape) != (nb, 2):
        raise ValueError(f"rc0 must be ({nb}, 2), got {tuple(rc0.shape)}")
    _check_starts(rel, frac, (2, nb, bq), device)
    _check_staged([vol])
    out = torch.empty((nb, k * k, bq), dtype=out_dtype, device=device)
    fn = _entry("local_lookup", "woft_local_lookup_fine")
    with _current(device):
        rc = fn(vol.data_ptr(), vol.shape[1], vol.shape[2], rc0.data_ptr(),
                rel.data_ptr(), frac.data_ptr(), nb, bq, k,
                int(dtype == torch.bfloat16), out.data_ptr(),
                int(out_dtype == torch.bfloat16),
                _stream())
    _raise_on_error(rc, "local_lookup_fine")
    local_lookup_fine.launches += 1
    return out


@_counted
def local_lookup_exact(vols, starts, frac, k, flag=None, out=None,
                       channel=0):
    """Kernel E: every level of a lookup over the whole stored windows, in
    one launch.

    vols: L (NB, wh, ww, BQ) CUDA volumes of one dtype; starts: (L, 2, NB,
    BQ) int32 absolute slab starts ([l, 0] rows, [l, 1] columns); frac:
    (L, 2, NB, BQ) float32. Without ``out`` returns a new (NB, L*k*k, BQ)
    float32. With ``out`` (NB, C, BQ) float32 or bfloat16 it writes level
    l into channels ``channel + l*k*k .. channel + (l+1)*k*k`` in place and
    returns ``out``; with ``flag`` (NB,) uint8 only the blocks whose flag
    is non-zero are written."""
    device, dtype, nb, bq = _check_volumes(vols, k)
    L = len(vols)
    if not 1 <= L <= 8:
        raise ValueError(f"1 to 8 levels, got {L}")
    _check_starts(starts, frac, (L, 2, nb, bq), device)
    if out is None:
        if flag is not None:
            raise ValueError("a flag needs an output to leave rows in")
        out = torch.empty((nb, L * k * k, bq), dtype=torch.float32,
                          device=device)
    else:
        if out.dtype not in _VOLUME_DTYPES:
            raise TypeError(f"out must be float32 or bfloat16, got "
                            f"{out.dtype}")
        _check_tensor(out, "out", out.dtype, device)
        if (out.dim() != 3 or out.shape[0] != nb or out.shape[2] != bq
                or not 0 <= channel <= out.shape[1] - L * k * k):
            raise ValueError(f"out must be ({nb}, >= {channel + L * k * k}, "
                             f"{bq}), got {tuple(out.shape)}")
    if flag is not None:
        _check_tensor(flag, "flag", torch.uint8, device)
        if tuple(flag.shape) != (nb,):
            raise ValueError(f"flag must be ({nb},), got {tuple(flag.shape)}")
    ptrs = (ctypes.c_void_p * L)(*[v.data_ptr() for v in vols])
    whs = (ctypes.c_int * L)(*[v.shape[1] for v in vols])
    wws = (ctypes.c_int * L)(*[v.shape[2] for v in vols])
    fn = _entry("local_lookup", "woft_local_lookup_exact")
    with _current(device):
        rc = fn(ctypes.addressof(ptrs), ctypes.addressof(whs),
                ctypes.addressof(wws), L, starts.data_ptr(), frac.data_ptr(),
                None if flag is None else flag.data_ptr(), nb, bq, k,
                int(dtype == torch.bfloat16), out.data_ptr(), out.shape[1],
                channel, int(out.dtype == torch.bfloat16), _stream())
    _raise_on_error(rc, "local_lookup_exact")
    local_lookup_exact.launches += 1
    return out


_lookup_table = [None, None]    # key and ctypes arrays of the last layout


def _coord_operands(coords, vols, table, k, b0):
    """Shared checks of kernels D and E from coordinates -> (device, dtype,
    nb, bq, ctypes int table, ctypes float table, ctypes volume pointers).
    ``table``: (ints, floats), ``models/corr.py:_lookup_constants``'s
    ``table``; its ctypes arrays are kept for the last layout. The volumes
    hold blocks ``b0 .. b0 + nb - 1`` of the table's grid."""
    device, dtype, nb, bq = _check_volumes(vols, k)
    if _lookup_table[0] != table:
        ints, floats = table
        _lookup_table[:] = table, ((ctypes.c_int * len(ints))(*ints),
                                   (ctypes.c_float * len(floats))(*floats))
    ints, floats = table
    L = len(vols)
    H1, W1, nbw, bh, bw, r = ints[:6]
    if not 1 <= L <= 8 or len(ints) != 6 + 10 * L or len(floats) != 4 * L:
        raise ValueError(f"a level table of {L} levels (1 to 8) expected")
    if (k != 2 * r + 1 or bq != bh * bw or b0 < 0
            or b0 + nb > -(-H1 // bh) * nbw):
        raise ValueError(f"volumes ({nb}, .., {bq}) from block {b0} and k = "
                         f"{k} do not match the level table's layout")
    for lvl, v in enumerate(vols):
        window = tuple(ints[6 + 10 * lvl:8 + 10 * lvl])
        if tuple(v.shape[1:3]) != window:
            raise ValueError(f"vols[{lvl}] is {tuple(v.shape)}, the level "
                             f"table's window is {window}")
    _check_tensor(coords, "coords", torch.float32, device)
    if tuple(coords.shape) != (1, H1, W1, 2) or coords.data_ptr() % 8:
        raise ValueError(f"coords must be an 8-byte aligned (1, {H1}, {W1}, "
                         f"2), got {tuple(coords.shape)}")
    ptrs = (ctypes.c_void_p * L)(*[v.data_ptr() for v in vols])
    return (device, dtype, nb, bq) + _lookup_table[1] + (ptrs,)


@_counted
def local_lookup_coords(coords, vols, table, k, out_dtype, b0=0):
    """Kernel D from coordinates: every level's fine-window lookup in one
    launch, each query's start, fraction and its block's anchor and flags
    computed in the kernel.

    coords: (1, H1, W1, 2) float32 CUDA level-0 (x, y); vols: L (NB, wh,
    ww, BQ) CUDA volumes of one dtype, 16-byte aligned, BQ a multiple of 16,
    blocks ``b0 .. b0 + NB - 1`` of the layout's grid (the whole grid, or
    a band of it: the queries and window origins of block b are those of
    the grid's block b0 + b); table: the layout's level table
    (``models/corr.py:_lookup_constants``). Returns (out (NB, L*k*k, BQ)
    ``out_dtype``, channel l*k*k + j*k + i; bad (NB, L) uint8, 1 where a
    start of the block left its fine window at that level)."""
    device, dtype, nb, bq, ints, floats, ptrs = _coord_operands(
        coords, vols, table, k, b0)
    if out_dtype not in _VOLUME_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    _check_staged(vols)
    L = len(vols)
    out = torch.empty((nb, L * k * k, bq), dtype=out_dtype, device=device)
    bad = torch.empty((nb, L), dtype=torch.uint8, device=device)
    fn = _entry("local_lookup", "woft_local_lookup_coords")
    with _current(device):
        rc = fn(coords.data_ptr(), ctypes.addressof(ptrs), L,
                ctypes.addressof(ints), ctypes.addressof(floats), b0, nb, bq,
                k, int(dtype == torch.bfloat16), out.data_ptr(),
                int(out_dtype == torch.bfloat16), bad.data_ptr(), _stream())
    _raise_on_error(rc, "local_lookup_coords")
    local_lookup_coords.launches += 1
    return out, bad


@_counted
def local_lookup_exact_coords(coords, vols, table, k, bad=None, out=None,
                              b0=0):
    """Kernel E from coordinates: every level of a lookup over the whole
    stored windows in one launch, each query's start and fraction computed
    in the kernel.

    coords, vols, table, b0 as for ``local_lookup_coords``. Without
    ``out`` returns a new (NB, L*k*k, BQ) float32. With ``out`` (NB,
    L*k*k, BQ) float32 or bfloat16 it writes in place and returns ``out``;
    with ``bad`` (NB, L) uint8 only the blocks with a flag set at some
    level."""
    device, dtype, nb, bq, ints, floats, ptrs = _coord_operands(
        coords, vols, table, k, b0)
    L = len(vols)
    if out is None:
        if bad is not None:
            raise ValueError("flags need an output to leave rows in")
        out = torch.empty((nb, L * k * k, bq), dtype=torch.float32,
                          device=device)
    else:
        if out.dtype not in _VOLUME_DTYPES:
            raise TypeError(f"out must be float32 or bfloat16, got "
                            f"{out.dtype}")
        _check_tensor(out, "out", out.dtype, device)
        if tuple(out.shape) != (nb, L * k * k, bq):
            raise ValueError(f"out must be ({nb}, {L * k * k}, {bq}), got "
                             f"{tuple(out.shape)}")
    if bad is not None:
        _check_tensor(bad, "bad", torch.uint8, device)
        if tuple(bad.shape) != (nb, L):
            raise ValueError(f"bad must be ({nb}, {L}), got "
                             f"{tuple(bad.shape)}")
    fn = _entry("local_lookup", "woft_local_lookup_exact_coords")
    with _current(device):
        rc = fn(coords.data_ptr(), ctypes.addressof(ptrs), L,
                ctypes.addressof(ints), ctypes.addressof(floats),
                None if bad is None else bad.data_ptr(), b0, nb, bq, k,
                int(dtype == torch.bfloat16), out.data_ptr(),
                int(out.dtype == torch.bfloat16), _stream())
    _raise_on_error(rc, "local_lookup_exact_coords")
    local_lookup_exact_coords.launches += 1
    return out


def _check_operand(t, what, dtype, device, shape):
    """An operand of the update-block kernels: exact shape, contiguous,
    16-byte aligned (the kernels read 16 bytes a thread)."""
    _check_tensor(t, what, dtype, device)
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} must be {shape}, got {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned")


GRU_X_CHANNELS = (128, 256)     # kernel G's motion widths: RAFT's and GMA's


@_counted
def fused_gru_update(h, x, pre_zr, pre_q, wzr, wq, bzr, bq, axis):
    """Kernel G: one direction of the SepConvGRU's gated update.

    All maps channels-minor, CUDA, contiguous: h (1, H, W, 128) float32
    state; x (1, H, W, X) bf16 motion features, X = 128 (RAFT) or 256
    (GMA's ``cat(mf, mf_g)``); pre_zr (1, H, W, 256) and pre_q (1, H, W,
    128) bf16 hoisted context terms; wzr (5, 256, 128 + X) and wq (5, 128,
    128 + X) bf16 taps over cat(h, x) and cat(r * h, x), input channels
    minor; bzr (256,), bq (128,) float32. ``axis``: 'w' (the 1x5 update) or
    'h' (5x1). Returns the new (1, H, W, 128) float32 state; the rounding
    points are ``models/update.py:gru_update_plain``'s."""
    if h.device.type != "cuda":
        raise ValueError("fused_gru_update takes CUDA tensors")
    if axis not in ("w", "h"):
        raise ValueError(f"axis must be 'w' or 'h', got {axis!r}")
    if h.dim() != 4 or h.shape[0] != 1 or min(h.shape) == 0:
        raise ValueError(f"h must be a non-empty (1, H, W, 128), got "
                         f"{tuple(h.shape)}")
    device, hw = h.device, tuple(h.shape[1:3])
    bf16 = torch.bfloat16
    cx = x.shape[-1] if x.dim() == 4 else 0
    if cx not in GRU_X_CHANNELS:
        raise ValueError(f"x must be (1, H, W, X), X in {GRU_X_CHANNELS}, "
                         f"got {tuple(x.shape)}")
    _check_operand(h, "h", torch.float32, device, (1, *hw, 128))
    _check_operand(x, "x", bf16, device, (1, *hw, cx))
    _check_operand(pre_zr, "pre_zr", bf16, device, (1, *hw, 256))
    _check_operand(pre_q, "pre_q", bf16, device, (1, *hw, 128))
    _check_operand(wzr, "wzr", bf16, device, (5, 256, 128 + cx))
    _check_operand(wq, "wq", bf16, device, (5, 128, 128 + cx))
    _check_operand(bzr, "bzr", torch.float32, device, (256,))
    _check_operand(bq, "bq", torch.float32, device, (128,))
    H, W = hw
    # lines, positions along the convolution, and their pixel strides
    geom = (H, W, W, 1) if axis == "w" else (W, H, 1, W)
    out = torch.empty_like(h)
    fn = _entry("gru")
    with _current(device):
        rc = fn(h.data_ptr(), x.data_ptr(), pre_zr.data_ptr(),
                pre_q.data_ptr(), wzr.data_ptr(), wq.data_ptr(),
                bzr.data_ptr(), bq.data_ptr(), out.data_ptr(), cx, *geom,
                _stream())
    _raise_on_error(rc, "gru_update")
    fused_gru_update.launches += 1
    return out


@_counted
def fused_gru_update_f32(h, x, pre_zr, pre_q, w, b, axis):
    """Kernel G's float32 form: one direction of the SepConvGRU's gated
    update in float32, products on FFMA.

    All maps float32, channels-minor, CUDA, contiguous: h (1, H, W, 128)
    state; x (1, H, W, 128) motion features; pre_zr (1, H, W, 256) and
    pre_q (1, H, W, 128) hoisted context terms; w (3, 256, 5, 128) taps of
    z, r and q over cat(h, x) and cat(r * h, x) (input channel, tap, output
    channel); b (384,) biases bz | br | bq. ``axis``: 'w' (the 1x5 update) or
    'h' (5x1). Returns the new (1, H, W, 128) state; the arithmetic is
    ``models/update.py:gru_update_f32_plain``'s."""
    if h.device.type != "cuda":
        raise ValueError("fused_gru_update_f32 takes CUDA tensors")
    if axis not in ("w", "h"):
        raise ValueError(f"axis must be 'w' or 'h', got {axis!r}")
    if h.dim() != 4 or h.shape[0] != 1 or min(h.shape) == 0:
        raise ValueError(f"h must be a non-empty (1, H, W, 128), got "
                         f"{tuple(h.shape)}")
    device, hw = h.device, tuple(h.shape[1:3])
    f32 = torch.float32
    _check_operand(h, "h", f32, device, (1, *hw, 128))
    _check_operand(x, "x", f32, device, (1, *hw, 128))
    _check_operand(pre_zr, "pre_zr", f32, device, (1, *hw, 256))
    _check_operand(pre_q, "pre_q", f32, device, (1, *hw, 128))
    _check_operand(w, "w", f32, device, (3, 256, 5, 128))
    _check_operand(b, "b", f32, device, (384,))
    H, W = hw
    # lines, positions along the convolution, and their pixel strides
    geom = (H, W, W, 1) if axis == "w" else (W, H, 1, W)
    out = torch.empty_like(h)
    fn = _entry("gru_f32")
    with _current(device):
        rc = fn(h.data_ptr(), x.data_ptr(), pre_zr.data_ptr(),
                pre_q.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                128, *geom, _stream())
    _raise_on_error(rc, "gru_update_f32")
    fused_gru_update_f32.launches += 1
    return out


@_counted
def motion_encoder_tail(cor1, flo1, flow, wc2, bc2, wf2, bf2, wcv, bcv,
                        mid=None):
    """Kernel H: the motion encoder's 3x3 stack, two launches.

    Channels-minor CUDA maps: cor1 (1, H, W, 256) and flo1 (1, H, W, 128)
    bf16 (relu of convc1 and convf1), flow (1, H, W, 2) float32; taps wc2
    (9, 192, 256), wf2 (9, 64, 128), wcv (9, 128, 256) bf16 with input
    channels minor (wcv's output rows 126 and 127 are padding); biases bc2
    (192,), bf2 (64,), bcv (128,) float32. Returns (1, H, W, 128) bf16:
    ``cat(out126, bf16(flow))``; the rounding points are
    ``models/update.py:motion_encoder_tail_plain``'s. The first launch
    writes ``cat(cor2, flo2)`` into ``mid``, a (1, H, W, 256) bf16 map
    (allocated here when None), which the second convolves: a caller that
    passes it can hold it against ``motion_encoder_stage1_plain``."""
    if cor1.device.type != "cuda":
        raise ValueError("motion_encoder_tail takes CUDA tensors")
    if cor1.dim() != 4 or cor1.shape[0] != 1 or min(cor1.shape) == 0:
        raise ValueError(f"cor1 must be a non-empty (1, H, W, 256), got "
                         f"{tuple(cor1.shape)}")
    device, hw = cor1.device, tuple(cor1.shape[1:3])
    bf16 = torch.bfloat16
    _check_operand(cor1, "cor1", bf16, device, (1, *hw, 256))
    _check_operand(flo1, "flo1", bf16, device, (1, *hw, 128))
    _check_operand(flow, "flow", torch.float32, device, (1, *hw, 2))
    _check_operand(wc2, "wc2", bf16, device, (9, 192, 256))
    _check_operand(wf2, "wf2", bf16, device, (9, 64, 128))
    _check_operand(wcv, "wcv", bf16, device, (9, 128, 256))
    _check_operand(bc2, "bc2", torch.float32, device, (192,))
    _check_operand(bf2, "bf2", torch.float32, device, (64,))
    _check_operand(bcv, "bcv", torch.float32, device, (128,))
    if mid is None:
        mid = torch.empty((1, *hw, 256), dtype=bf16, device=device)
    _check_operand(mid, "mid", bf16, device, (1, *hw, 256))
    out = torch.empty((1, *hw, 128), dtype=bf16, device=device)
    fn = _entry("update_tail", "woft_motion_encoder_tail")
    with _current(device):
        rc = fn(cor1.data_ptr(), flo1.data_ptr(), flow.data_ptr(),
                wc2.data_ptr(), bc2.data_ptr(), wf2.data_ptr(),
                bf2.data_ptr(), wcv.data_ptr(), bcv.data_ptr(),
                mid.data_ptr(), out.data_ptr(), *hw, _stream())
    _raise_on_error(rc, "motion_encoder_tail")
    motion_encoder_tail.launches += 1
    return out


@_counted
def flow_head(net, w1, b1, w2, b2):
    """Kernel I: the flow head, ``conv2(relu(conv1(net)))``.

    net (1, H, W, 128) float32 CUDA, channels minor (rounded to bf16 as it
    is read); taps w1 (9, 256, 128), w2 (9, 2, 256) bf16 with input channels
    minor; b1 (256,), b2 (2,) float32. Returns the (1, H, W, 2) float32
    delta, never rounded; the rounding points are
    ``models/update.py:flow_head_plain``'s."""
    if net.device.type != "cuda":
        raise ValueError("flow_head takes CUDA tensors")
    if net.dim() != 4 or net.shape[0] != 1 or min(net.shape) == 0:
        raise ValueError(f"net must be a non-empty (1, H, W, 128), got "
                         f"{tuple(net.shape)}")
    device, hw = net.device, tuple(net.shape[1:3])
    _check_operand(net, "net", torch.float32, device, (1, *hw, 128))
    _check_operand(w1, "w1", torch.bfloat16, device, (9, 256, 128))
    _check_operand(w2, "w2", torch.bfloat16, device, (9, 2, 256))
    _check_operand(b1, "b1", torch.float32, device, (256,))
    _check_operand(b2, "b2", torch.float32, device, (2,))
    out = torch.empty((1, *hw, 2), dtype=torch.float32, device=device)
    fn = _entry("flow_head")
    with _current(device):
        rc = fn(net.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), out.data_ptr(), *hw, _stream())
    _raise_on_error(rc, "flow_head")
    flow_head.launches += 1
    return out


@_counted
def gma_aggregate(attn, vt, mf, gamma):
    """Kernel M: GMA's aggregation with its residual, ``cat(mf, bf16(mf +
    gamma * attn @ v))``.

    attn (N, N) bf16 CUDA, the template's attention (rows sum to 1), rows
    contiguous and their stride a multiple of 8 elements (a view of wider
    rows is fine); vt (128, N) bf16, ``v`` transposed, rows as attn's; mf
    (N, 128) bf16, contiguous, the motion features; gamma (1,) float32 on
    the card, read there (no host copy). Returns (N, 256) bf16, ``mf`` then
    ``mf_g``: the SepConvGRU's recurrent input. The products are bf16 with
    float32 sums; the rounding points are
    ``models/gma.py:gma_aggregate_plain``'s."""
    if attn.device.type != "cuda":
        raise ValueError("gma_aggregate takes CUDA tensors")
    if attn.dim() != 2 or attn.shape[0] != attn.shape[1] or not attn.numel():
        raise ValueError(f"attn must be a non-empty (N, N), got "
                         f"{tuple(attn.shape)}")
    device, N = attn.device, attn.shape[0]
    bf16 = torch.bfloat16
    for name, t, shape in (("attn", attn, (N, N)), ("vt", vt, (128, N))):
        if t.device != device or t.dtype != bf16 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a {shape} bfloat16 tensor on "
                             f"{device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
        if t.stride(1) != 1 or t.stride(0) % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name}'s rows must be contiguous, 16-byte "
                             f"aligned, a multiple of 8 elements apart")
    _check_operand(mf, "mf", bf16, device, (N, 128))
    _check_operand(gamma, "gamma", torch.float32, device, (1,))
    out = torch.empty((N, 256), dtype=bf16, device=device)
    fn = _entry("gma_aggregate")
    with _current(device):
        rc = fn(attn.data_ptr(), attn.stride(0), vt.data_ptr(), vt.stride(0),
                mf.data_ptr(), gamma.data_ptr(), out.data_ptr(), N,
                _stream())
    _raise_on_error(rc, "gma_aggregate")
    gma_aggregate.launches += 1
    return out


HEAD_TAP_ROWS = 19 * 128        # kernel J's tap blocks of 128 output rows


@_counted
def weight_head(corr, mean, taps, consts):
    """Kernel J: the weight head's logits of M rows in bf16 mode.

    corr (M, 324) float32 or bf16 CUDA, a row's lookup in the dense
    lookup's channel order; mean (M,) float32, its mean response; taps
    (19 * 128, 128) bf16 and consts (513,) float32 from
    ``models/weight_head.py:head_params``. Returns the (M,) float32 logits;
    the rounding points are ``models/weight_head.py:weight_head_plain``'s."""
    if corr.device.type != "cuda":
        raise ValueError("weight_head takes CUDA tensors")
    if corr.dim() != 2 or corr.shape[1] != 324 or corr.shape[0] == 0:
        raise ValueError(f"corr must be a non-empty (M, 324), got "
                         f"{tuple(corr.shape)}")
    if corr.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"corr must be float32 or bfloat16, got {corr.dtype}")
    device, M = corr.device, corr.shape[0]
    if M >= 2 ** 31:
        raise ValueError("the kernel takes fewer than 2^31 rows")
    _check_tensor(corr, "corr", corr.dtype, device)
    _check_tensor(mean, "mean", torch.float32, device)
    if tuple(mean.shape) != (M,):
        raise ValueError(f"mean must be ({M},), got {tuple(mean.shape)}")
    _check_operand(taps, "taps", torch.bfloat16, device, (HEAD_TAP_ROWS, 128))
    _check_operand(consts, "consts", torch.float32, device, (4 * 128 + 1,))
    out = torch.empty(M, dtype=torch.float32, device=device)
    fn = _entry("weight_head")
    with _current(device):
        rc = fn(corr.data_ptr(), int(corr.dtype == torch.bfloat16),
                mean.data_ptr(), taps.data_ptr(), consts.data_ptr(),
                out.data_ptr(), M, _stream())
    _raise_on_error(rc, "weight_head")
    weight_head.launches += 1
    return out


_NORM_DTYPES = (torch.float32, torch.bfloat16)
NORM_THREADS = 256              # kernel L's block
NORM_MAX_SPLITS = 256           # partials a plane: one a thread of the merge
_sm_counts = {}


def instance_norm_plan(planes, hw, vec, sms):
    """Kernel L's split of each of ``planes`` planes of ``hw`` elements:
    (splits, chunk), chunk a multiple of ``vec`` (the elements of a load)
    and every chunk non-empty. About two waves of eight 256-thread blocks
    on each of ``sms`` SMs, no more splits than leave a block two
    iterations of two loads a thread, and at most ``NORM_MAX_SPLITS``."""
    per_block = 2 * 2 * NORM_THREADS * vec
    splits = max(1, min(-(-16 * sms // planes), -(-hw // per_block),
                        NORM_MAX_SPLITS))
    chunk = -(-hw // splits)
    chunk = -(-chunk // vec) * vec
    return -(-hw // chunk), chunk


def _sm_count(device):
    if device.index not in _sm_counts:
        _sm_counts[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_counts[device.index]


def _add_bias(x, bias):
    return x if bias is None else x + bias.view(1, -1, 1, 1)


def instance_norm_act_plain(x, residual=None, shortcut=None, eps=1e-5,
                            bias=None, shortcut_bias=None):
    """Kernel L's function in PyTorch, the encoder modules' own calls:
    ``relu(instance_norm(x))``; with ``residual``, ``relu(residual +
    relu(instance_norm(x)))``; with ``shortcut``, the same with
    ``instance_norm(shortcut)`` as the residual. ``bias``,
    ``shortcut_bias``: (C,) added first to x and to the shortcut, as a
    convolution on the card adds its bias after cuDNN's product."""
    y = F.relu(F.instance_norm(_add_bias(x, bias), eps=eps))
    if shortcut is not None:
        residual = F.instance_norm(_add_bias(shortcut, shortcut_bias),
                                   eps=eps)
    return y if residual is None else F.relu(residual + y)


@_counted
def instance_norm_act(x, residual=None, shortcut=None, eps=1e-5, bias=None,
                      shortcut_bias=None):
    """Kernel L: the instance norm (affine-free, biased variance) of an
    NCHW map with the convolution's bias before it, the ReLU after it and,
    at a residual block's end, the add and its ReLU:
    ``instance_norm_act_plain``'s function, two launches (the statistics,
    then the apply pass), three for the stem.

    x: (N, C, H, W) float32 or bf16, contiguous, or with channels-last
    strides and no residual (the stem: a convolution's output that kept
    its NHWC input's strides; three launches, the output contiguous);
    residual: x's shape and type, the block's input; shortcut: the same,
    the shortcut convolution's output, normalised on the fly (at most one
    of the two); bias, shortcut_bias: None or (C,) of x's type. Each
    biased value rounded to x's type, statistics in float32, each
    normalised value rounded to x's type, the add in float32 rounded once.
    A CPU tensor takes ``instance_norm_act_plain``."""
    if residual is not None and shortcut is not None:
        raise ValueError("a residual or a shortcut to normalise, not both")
    if shortcut_bias is not None and shortcut is None:
        raise ValueError("a shortcut bias needs a shortcut")
    require_no_grad("L (instance_norm_act)", x, residual, shortcut, bias,
                    shortcut_bias)
    if x.device.type != "cuda":
        return instance_norm_act_plain(x, residual, shortcut, eps, bias,
                                       shortcut_bias)
    device = x.device
    if x.dtype not in _NORM_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    other = residual if shortcut is None else shortcut
    # the stem: a convolution's output that kept its NHWC input's strides
    stem = (other is None and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))
    if not stem:
        _check_tensor(x, "x", x.dtype, device)
    if other is not None:
        _check_tensor(other, "residual" if shortcut is None else "shortcut",
                      x.dtype, device)
        if other.shape != x.shape:
            raise ValueError(f"the residual or shortcut must be "
                             f"{tuple(x.shape)}, got {tuple(other.shape)}")
    N, C, H, W = x.shape
    for name, b in (("bias", bias), ("shortcut_bias", shortcut_bias)):
        if b is not None:
            _check_tensor(b, name, x.dtype, device)
            if tuple(b.shape) != (C,):
                raise ValueError(f"{name} must be ({C},), got "
                                 f"{tuple(b.shape)}")
    planes, hw = N * C, H * W
    if hw >= 2 ** 31:
        raise ValueError("kernel L indexes a plane with 32 bits")
    if stem:
        return _instance_norm_stem(x, bias, eps)
    out = torch.empty_like(x)
    vec = 16 // x.element_size()
    if hw % vec or any(t.data_ptr() % 16 for t in (x, other, out)
                       if t is not None):
        vec = 1
    splits, chunk = instance_norm_plan(planes, hw, vec, _sm_count(device))
    mode = 0 if other is None else 1 if shortcut is None else 2
    part = torch.empty((2 if mode == 2 else 1, planes, splits, 4),
                       dtype=torch.float32, device=device)
    fn = _entry("instance_norm")
    with _current(device):
        rc = fn(x.data_ptr(), None if other is None else other.data_ptr(),
                None if bias is None else bias.data_ptr(),
                None if shortcut_bias is None else shortcut_bias.data_ptr(),
                mode, int(x.dtype == torch.bfloat16), planes, C, hw, splits,
                chunk, vec, eps, part.data_ptr(), out.data_ptr(), _stream())
    _raise_on_error(rc, "instance_norm")
    instance_norm_act.launches += 2
    return out


NORM_STEM_MAX_CHANNELS = 128
NORM_STEM_MAX_SPLITS = 1024     # partials a plane: 32 a lane of one warp


def instance_norm_stem_plan(images, hw, sms):
    """The stem form's split of each image's ``hw`` positions: (splits,
    chunk), every chunk non-empty; about two waves of eight blocks an SM,
    at least 256 positions a block, at most ``NORM_STEM_MAX_SPLITS``."""
    splits = max(1, min(-(-16 * sms // images), -(-hw // 256),
                        NORM_STEM_MAX_SPLITS))
    chunk = -(-hw // splits)
    return -(-hw // chunk), chunk


def _instance_norm_stem(x, bias, eps):
    """Kernel L's channels-last form (``instance_norm_act`` on a map with
    NHWC strides, no residual): three launches (the statistics, the planes'
    coefficients, the apply pass), the output NCHW."""
    device = x.device
    N, C, H, W = x.shape
    vec = 16 // x.element_size()
    if (C % vec or NORM_THREADS % (C // vec) or C > NORM_STEM_MAX_CHANNELS
            or x.data_ptr() % 16 or N > 65535):
        raise ValueError(f"kernel L takes a channels-last map with a multiple "
                         f"of {vec} channels up to {NORM_STEM_MAX_CHANNELS} "
                         f"(their 16-byte vectors dividing {NORM_THREADS}), "
                         f"16-byte aligned; got {tuple(x.shape)}")
    hw = H * W
    splits, chunk = instance_norm_stem_plan(N, hw, _sm_count(device))
    out = torch.empty((N, C, H, W), dtype=x.dtype, device=device)
    part = torch.empty((N * C, splits, 4), dtype=torch.float32, device=device)
    coef = torch.empty((N * C, 2), dtype=torch.float32, device=device)
    fn = _entry("instance_norm", "woft_instance_norm_nhwc")
    with _current(device):
        rc = fn(x.data_ptr(), None if bias is None else bias.data_ptr(),
                int(x.dtype == torch.bfloat16), N, C, hw, splits, chunk, eps,
                part.data_ptr(), coef.data_ptr(), out.data_ptr(), _stream())
    _raise_on_error(rc, "instance_norm")
    instance_norm_act.launches += 3
    return out


SOBOL_TILE = 8192               # kernel N's tile of mask bytes
SOBOL_MAX_TILES = 8192          # a row's tile prefixes in the select pass


def sobol_select_plan(P):
    """Kernel N's tiles of a row of ``P`` slots: (tile, tiles), the tile
    the least multiple of ``SOBOL_TILE`` that cuts the row into at most
    ``SOBOL_MAX_TILES`` (the select pass keeps their prefixes in shared
    memory)."""
    tile = SOBOL_TILE * -(-P // (SOBOL_TILE * SOBOL_MAX_TILES))
    return tile, -(-P // tile)


@_counted
def masked_sobol_select(valid, sobol):
    """Kernel N: the Sobol-n selection of each row's valid slots,
    ``ops/sampling.py:masked_sobol_gather_plain``'s function, two launches
    (the tiles' counts, then one warp a target).

    valid (N, P) bool CUDA, contiguous, one row a target, P < 2^31; sobol
    (n,) float32 on the same card: the first n points of the 1-D Sobol
    sequence sorted ascending (``ops/sampling.py:_sobol_sorted_on``).
    Returns (idx (N, n) int64, sel (N, n) bool), equal to the plain
    version's at every slot."""
    if valid.device.type != "cuda":
        raise ValueError("masked_sobol_select takes CUDA tensors")
    device = valid.device
    _check_tensor(valid, "valid", torch.bool, device)
    if valid.dim() != 2 or valid.numel() == 0:
        raise ValueError(f"valid must be a non-empty (N, P), got "
                         f"{tuple(valid.shape)}")
    N, P = valid.shape
    if P >= 2 ** 31 or N > 65535:
        raise ValueError(f"kernel N takes fewer than 2^31 slots a row and "
                         f"at most 65,535 rows, got {tuple(valid.shape)}")
    _check_tensor(sobol, "sobol", torch.float32, device)
    if sobol.dim() != 1 or sobol.numel() == 0:
        raise ValueError(f"sobol must be a non-empty (n,), got "
                         f"{tuple(sobol.shape)}")
    n = sobol.numel()
    tile, tiles = sobol_select_plan(P)
    counts = torch.empty((N, tiles), dtype=torch.int32, device=device)
    idx = torch.empty((N, n), dtype=torch.int64, device=device)
    sel = torch.empty((N, n), dtype=torch.bool, device=device)
    vec = int(P % 16 == 0 and valid.data_ptr() % 16 == 0)
    fn = _entry("sobol_select")
    with _current(device):
        rc = fn(valid.data_ptr(), sobol.data_ptr(), N, P, n, tile, tiles, vec,
                counts.data_ptr(), idx.data_ptr(), sel.data_ptr(), _stream())
    _raise_on_error(rc, "sobol_select")
    masked_sobol_select.launches += 2
    return idx, sel
