"""Build, bind and launch the port's hand-written CUDA kernels.

The counterpart of the JAX package's ``ops/pallas/``.  Each ``csrc/*.cu`` is
compiled with ``nvcc`` for ``sm_90a`` into a shared library of its own with
a plain C interface, at first use, into ``build/`` beside ``csrc/``
(gitignored); the compilers run side by side, and a file name carries a
hash of its source, so an edit rebuilds.  The libraries are loaded with
``ctypes``: every pointer and the stream are ``c_void_p``, and each C entry
point returns ``cudaGetLastError()`` after its launch, which the launcher
here raises on.

Each launcher counts its launches in ``launches`` (a plain integer per
kernel source, bumped only where a kernel is launched), so a run can show
that the main path went through the kernels.  Nothing here imports or
builds anything when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("ntt.cu", "poseidon.cu", "field.cu", "gates.cu", "sha256.cu")
HEADERS = ("goldilocks.cuh", "poseidon.cuh", "bulk.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

NTT_THREADS = 256
POSEIDON_THREADS = 256  # csrc/poseidon.cu: __launch_bounds__(256, ...), the most it takes
FIELD_THREADS = 256  # csrc/field.cu: __launch_bounds__(256)
FIELD_OPS = {"add": 0, "sub": 1, "mul": 2}  # csrc/field.cu: OP_ADD, OP_SUB, OP_MUL
FIELD_INV_RUN = 16  # csrc/field.cu: INV_RUN, the words a thread inverts together
# csrc/field.cu's G kernel: G_TAGS batches, G_MAX_SPECS specs, G_MAX_ROWS rows
# in all; persistent blocks (one an SM) walk tiles of G_TILE
# columns, the rows arriving G_STAGE_ROWS at a time by bulk copies
G_TAGS = 4
G_MAX_SPECS = 16
G_MAX_ROWS = 2048
G_TILE = 256
G_STAGE_ROWS = 8
# csrc/field.cu's openings: a launch takes a table of at most OPEN_MAX_BATCHES
# entries of at most OPEN_MAX_POINTS points each (a batch with more points
# takes several entries, more entries take more launches);
# a block takes OPEN_ROWS rows of one entry and OPEN_CHUNK columns, OPEN_KS
# columns a stage; the power table's rows are padded to whole stages
OPEN_MAX_BATCHES = 8
OPEN_MAX_POINTS = 8
OPEN_ROWS = 32
OPEN_MTILES = 2
OPEN_NTILES = 2
OPEN_KS = 256
OPEN_CHUNK = 4096
OPEN_CLASSES = 15
# csrc/field.cu's permutation terms: PERM_CHALLENGES, PERM_MAX_ROUTED,
# PERM_MAX_CHUNKS; persistent blocks (PERM_MIN_BLOCKS an SM) walk tiles of
# PERM_TILE columns, the rows arriving by bulk copies into a ring of
# PERM_STAGES stages of PERM_STAGE_ROWS slots (PERM_PAIRS wire and sigma rows
# and a chain row a challenge)
# the fewest columns of a tile of the bulk copies' rings: a copy of a 2-D
# tensor map lands on a 128-byte boundary of shared memory
MIN_TILE = 16
PERM_CHALLENGES = 2
PERM_MAX_ROUTED = 256
PERM_MAX_CHUNKS = 64
PERM_TILE = 256
PERM_PAIRS = 8
PERM_STAGE_ROWS = 2 * PERM_PAIRS + PERM_CHALLENGES
PERM_STAGES = 3
PERM_MIN_BLOCKS = 2
# csrc/field.cu's Z and partials: perm_z_kernel's block of PERM_Z_THREADS
# columns, halved while its dynamic shared memory (two words a chunk,
# challenge and thread) would pass PERM_Z_SHARED_TARGET, two blocks an SM;
# perm_z_scan_kernel's one block of PERM_Z_SCAN_THREADS a challenge
PERM_Z_THREADS = 256
PERM_Z_SCAN_THREADS = 256
PERM_Z_SHARED_TARGET = 96 * 1024
GATES_THREADS = 256  # csrc/gates.cu: __launch_bounds__(256, ...)
GATES_CHALLENGES = 2  # csrc/gates.cu: NCH, the challenges one launch takes (the prover's 2)
# csrc/gates.cu's SHA-256 gate: SHA_TILE columns a block, each staged column
# STAGE_STRIDE words; at most SHA_MAX_SHARED_BYTES of shared memory a block
SHA_TILE = 256
SHA_STAGE_STRIDE = 33
SHA_MAX_SHARED_BYTES = 227 * 1024
# csrc/gates.cu's generic gates: fewer than GEN_MAX_CONSTRAINTS constraints a
# gate, at most GEN_BS_MAX_BITS bits a BaseSum2Gate slot of GEN_BS_STRIDE wires;
# persistent blocks (GEN_MIN_BLOCKS of GEN_TILE threads an SM) walk tiles of
# GEN_TILE columns, a tile's head in one slot and its wire rows GEN_STAGE_ROWS
# a stage in a ring of GEN_STAGES, fewer (down to 2), then narrower tiles (down
# to GEN_MIN_TILE) where the head would not fit; at most GEN_MAX_SHARED_BYTES of
# shared memory a block
GEN_MAX_CONSTRAINTS = 256
GEN_BS_MAX_BITS = 32
GEN_BS_STRIDE = 33
GENERIC_GATES = ("arith", "basesum2", "const")
GEN_TILE = 256
GEN_MIN_TILE = 32
GEN_STAGE_ROWS = 8
GEN_STAGES = 4
GEN_MIN_BLOCKS = 2
GEN_MAX_SHARED_BYTES = 227 * 1024 // GEN_MIN_BLOCKS - 1024
SHA256_THREADS = 256  # csrc/sha256.cu: __launch_bounds__(256)

launches = {"ntt": 0, "poseidon": 0, "field": 0, "gates": 0, "sha256": 0}
build_info: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel path), False for a CPU tensor (plain path)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _source_hash(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + (source,):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def _libraries() -> dict:
    """Build what is missing (one nvcc per source, all started together) and
    load the libraries; returns {source stem: CDLL}."""
    t0 = time.perf_counter()
    paths = {src: BUILD_DIR / f"libelp_{Path(src).stem}_{_source_hash(src)}.so" for src in SOURCES}
    running = {}
    for src, so in paths.items():
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / src)]
            running[src] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.PIPE, text=True))
    results = {src: (tmp, proc, *proc.communicate()) for src, (tmp, proc) in running.items()}
    ptxas = []
    for src, (tmp, proc, out, err) in results.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{out}\n{err}")
        os.replace(tmp, paths[src])
        ptxas.append(err)
    libs = {Path(src).stem: ctypes.CDLL(str(so)) for src, so in paths.items()}
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    signatures = {
        "ntt": {"elp_ntt_pass": [vp, vp, ll, i32, ll, ll, ll, ll, ll, ll, vp, vp, vp, vp, vp,
                                 ctypes.c_ulonglong, i32, i32, i32, i32, i32, vp]},
        "poseidon": {"elp_poseidon_set_constants": [vp, ll, vp],
                     "elp_poseidon_sponge": [vp, ll, ll, ll, ll, vp, i32, vp],
                     "elp_merkle_level": [vp, ll, vp, i32, vp],
                     "elp_merkle_tail": [vp, ll, i32, vp, i32, vp]},
        "field": {"elp_field_binary": [i32, vp, ll, ll, vp, ll, ll, vp, ll, ll, i32, vp],
                  "elp_field_inv": [vp, vp, ll, i32, vp],
                  "elp_field_open_table": [vp, vp, i32, ll, ll, vp, vp],
                  "elp_field_open": [i32, ctypes.POINTER(vp), ctypes.POINTER(ll),
                                     ctypes.POINTER(i32), ctypes.POINTER(i32), ctypes.POINTER(i32),
                                     ctypes.POINTER(ll), ctypes.POINTER(i32), i32, ll, i32, ll, ll,
                                     vp, ll, vp, vp, vp],
                  "elp_perm_quotient": [vp, ll, vp, ll, vp, ll, vp, vp, vp, vp, vp, vp, vp, ll,
                                        ll, i32, i32, i32, vp, i32, i32, vp],
                  "elp_perm_z": [vp, ll, vp, ll, vp, vp, vp, vp, ll, i32, i32, i32, vp, vp, i32, ll,
                                 ll, ll, i32, vp],
                  "elp_fri_g": [ctypes.POINTER(vp), ctypes.POINTER(ll), ctypes.POINTER(i32),
                                ctypes.POINTER(i32), i32, vp, vp, vp, vp, vp, vp, vp, ll, i32, i32,
                                vp, vp, vp],
                  "elp_fri_fold": [vp, vp, vp, ctypes.c_ulonglong, ctypes.c_ulonglong, vp, vp, vp,
                                   vp, ll, i32, vp]},
        "gates": {"elp_sha_gate_quotient": [vp, ll, ll, ll, i32, ctypes.POINTER(i32), vp, vp, vp, vp,
                                            vp, vp, vp, vp, vp, i32, i32, vp],
                  "elp_poseidon_gate_set_constants": [vp, ll, vp],
                  "elp_poseidon_gate_quotient": [vp, ll, ll, ctypes.POINTER(i32), vp, vp, vp, vp,
                                                 vp, i32, vp],
                  "elp_generic_gate_quotient": [vp, ll, vp, ll, ctypes.POINTER(vp), i32, i32, i32,
                                                i32, i32, vp, ll, vp, i32, vp, i32, i32,
                                                ctypes.POINTER(i32), i32, i32, vp, vp, i32, i32, vp,
                                                vp, ll, i32, i32, vp]},
        "sha256": {"elp_sha256_set_constants": [vp, ll, vp],
                   "elp_sha256_compress": [vp, vp, ll, vp, i32, vp],
                   "elp_sha256_two_to_one": [vp, vp, ll, vp, i32, vp]},
    }
    for stem, functions in signatures.items():
        for name, argtypes in functions.items():
            fn = getattr(libs[stem], name)
            fn.argtypes = argtypes
            fn.restype = i32
    build_info.update(paths=[str(so) for so in paths.values()], built=sorted(results),
                      ptxas="".join(ptxas), seconds=time.perf_counter() - t0)
    return libs


def build() -> dict:
    """Build (if needed) and load the kernels; returns ``build_info``."""
    _libraries()
    return build_info


def _check(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda" or t.dtype != torch.int64:
        raise ValueError(f"{name}: expected a CUDA int64 tensor, got {t.device} {t.dtype}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")


def ntt_pass(src, dst, *, total, K, in_strides, out_strides, tw, log_m, log_pad=0,
             step=None, in_tab=None, out_tab=None, scalar=None):
    """Launch one pass of ``csrc/ntt.cu`` (see its header for the addressing).

    ``in_strides`` / ``out_strides`` are (row, sub-transform, element) word
    strides, ``tw`` the stage twiddles w_m^k (k < m/2), ``step`` the two step
    twiddle tables of a four-step's column pass, ``log_pad`` the number of
    leading stages that the input's zero tail turns into copies.  ``dst``
    may be ``src``: each block reads all of its sub-transforms before it
    writes, and blocks touch disjoint ones.
    """
    tensors = [(src, "src"), (dst, "dst"), (tw, "tw"), (in_tab, "in_tab"), (out_tab, "out_tab")]
    if step is not None:
        tensors += [(step[0], "step lo"), (step[1], "step hi")]
    for t, name in tensors:
        if t is not None:
            _check(t, name)
    if (not 1 <= log_m <= 11 or not 0 <= log_pad <= log_m or K < 1 or K & (K - 1)
            or tw.numel() < max(1, (1 << log_m) >> 1)):
        raise ValueError(f"ntt pass: length 2^{log_m} (outside 2^1..2^11), padding 2^{log_pad}, "
                         f"{K} sub-transforms a row (not a power of two) or {tw.numel()} twiddles")
    if total == 0:
        return
    log_c = max(2, 12 - log_m)  # >= 4 sub-transforms and >= 4096 words per block

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _libraries()["ntt"].elp_ntt_pass(
        src.data_ptr(), dst.data_ptr(), total, K.bit_length() - 1, *in_strides, *out_strides, tw.data_ptr(),
        *((None, None) if step is None else (step[0].data_ptr(), step[1].data_ptr())),
        ptr(in_tab), ptr(out_tab), 0 if scalar is None else int(scalar), int(scalar is not None),
        log_m, log_c, log_pad, NTT_THREADS, _stream(dst))
    launches["ntt"] += 1
    _raise_on(err, "ntt")


@functools.lru_cache(maxsize=None)
def _poseidon_constants_on(device_index: int, consts: bytes) -> None:
    """Fill the sponge's __constant__ tables on this card, once a process."""
    with torch.cuda.device(device_index):
        err = _libraries()["poseidon"].elp_poseidon_set_constants(
            consts, len(consts), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "poseidon constants")


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def poseidon_sponge(x: torch.Tensor, consts: bytes) -> torch.Tensor:
    """Launch ``csrc/poseidon.cu`` on an (N, L) view of any strides -> (N, 4).

    A contiguous (N, 8) input is one Merkle level and runs
    ``merkle_level_kernel``; anything else runs ``sponge_kernel``.
    """
    _check(x, "x")
    if x.dim() != 2 or min(x.stride()) < 0:
        raise ValueError(f"poseidon_sponge: expected a 2-D view, got {tuple(x.shape)}")
    n, length = x.shape
    out = torch.empty((n, 4), dtype=torch.int64, device=x.device)
    if n == 0:
        return out
    _poseidon_constants_on(_device_index(x), consts)
    lib = _libraries()["poseidon"]
    if length == 8 and x.is_contiguous() and x.data_ptr() % 16 == 0:
        err = lib.elp_merkle_level(x.data_ptr(), n, out.data_ptr(), POSEIDON_THREADS, _stream(x))
    else:
        err = lib.elp_poseidon_sponge(x.data_ptr(), length, n, x.stride(1), x.stride(0),
                                      out.data_ptr(), POSEIDON_THREADS, _stream(x))
    launches["poseidon"] += 1
    _raise_on(err, "poseidon")
    return out


def merkle_tail(level: torch.Tensor, num_levels: int, consts: bytes) -> list:
    """Launch ``merkle_tail_kernel``: (2M, 4) digests -> the next ``num_levels``
    levels [(M, 4), (M/2, 4), ...], views of one buffer, in ONE launch."""
    _check(level, "level")
    pairs = level.shape[0] // 2
    if (num_levels < 1 or level.dim() != 2 or level.shape[1] != 4 or not level.is_contiguous()
            or level.data_ptr() % 16 or pairs >> (num_levels - 1) < 1 or pairs & (pairs - 1)):
        raise ValueError(f"merkle_tail: cannot compress {tuple(level.shape)} {num_levels} times")
    sizes = [pairs >> k for k in range(num_levels)]
    buf = torch.empty((sum(sizes), 4), dtype=torch.int64, device=level.device)
    _poseidon_constants_on(_device_index(level), consts)
    err = _libraries()["poseidon"].elp_merkle_tail(
        level.data_ptr(), pairs, num_levels, buf.data_ptr(), POSEIDON_THREADS, _stream(level))
    launches["poseidon"] += 1
    _raise_on(err, "poseidon")
    return list(buf.split(sizes))


def _rows_cols(t: torch.Tensor, shape: tuple):
    """``t`` broadcast to ``shape`` and read as (rows, cols) = (prod(shape[:-1]),
    shape[-1]): (tensor that owns the words, row stride, column stride).  The
    leading axes must collapse into one stride; a view that does not (rare:
    a slice across two leading axes) is copied first."""
    e = t.expand(shape)
    if len(shape) == 0:
        return e, 0, 0
    cols_stride = e.stride(-1) if shape[-1] > 1 else 0
    lead = [(n, st) for n, st in zip(shape[:-1], e.stride()[:-1]) if n > 1]
    if not lead:
        return e, 0, cols_stride
    for (_, outer), (n, inner) in zip(lead, lead[1:]):
        if outer != inner * n:
            e = e.contiguous()
            return e, shape[-1], 1
    return e, lead[-1][1], cols_stride


def field_binary_plan(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """How one launch of ``field_binary_kernel`` addresses a (op) b: (shape of
    the result, the two tensors that own the words, rows, cols, a's row and
    column stride, b's).  Element (r, c) of the contiguous (rows, cols) result
    reads word r * stride_r + c * stride_c of each operand's storage."""
    shape = tuple(torch.broadcast_shapes(a.shape, b.shape))
    ea, a_r, a_c = _rows_cols(a, shape)
    eb, b_r, b_c = _rows_cols(b, shape)
    if min(a_r, a_c, b_r, b_c) < 0:
        raise ValueError("field op: negative strides")
    cols = shape[-1] if shape else 1
    rows = math.prod(shape) // max(cols, 1)
    if cols == 1:  # a column: run along it
        rows, cols, a_r, a_c, b_r, b_c = 1, rows, 0, a_r, 0, b_r
    elif rows > 1 and {(a_r, a_c), (b_r, b_c)} <= {(cols, 1), (0, 0)}:
        # contiguous or scalar operands: one long row, so a narrow last axis
        # does not leave most of a block's threads without work
        rows, cols, a_r, b_r = 1, rows * cols, 0, 0
    return shape, ea, eb, rows, cols, a_r, a_c, b_r, b_c


def field_binary(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/field.cu``: a (op) b over the broadcast of the two shapes,
    op one of add, sub, mul; operands are read through their strides."""
    _check(a, "a")
    _check(b, "b")
    if a.device != b.device:
        raise ValueError(f"field {op}: operands on {a.device} and {b.device}")
    shape, ea, eb, rows, cols, a_r, a_c, b_r, b_c = field_binary_plan(a, b)
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    if out.numel() == 0:
        return out
    err = _libraries()["field"].elp_field_binary(
        FIELD_OPS[op], ea.data_ptr(), a_r, a_c, eb.data_ptr(), b_r, b_c, out.data_ptr(),
        rows, cols, FIELD_THREADS, _stream(out))
    launches["field"] += 1
    _raise_on(err, f"field {op}")
    return out


def field_inv_plan(n: int) -> dict:
    """How ``field_inv_kernel`` inverts n words: a block of ``threads`` takes
    tiles of ``tile`` words, ``blocks`` of them (the grid), and thread t of
    the tile at word b inverts its ``run`` words b + t + i * threads, i <
    run, together (one Fermat power; words at n or past it are absent)."""
    if n < 1:
        raise ValueError(f"field inv: {n} words")
    tile = FIELD_THREADS * FIELD_INV_RUN
    return {"threads": FIELD_THREADS, "run": FIELD_INV_RUN, "tile": tile, "blocks": -(-n // tile)}


def field_inv(a: torch.Tensor) -> torch.Tensor:
    """Launch ``field_inv_kernel``: a^(p-2) elementwise (0 stays 0), a run of
    words a thread by Montgomery's trick (``field_inv_plan``)."""
    _check(a, "a")
    x = a.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    plan = field_inv_plan(x.numel())
    err = _libraries()["field"].elp_field_inv(x.data_ptr(), out.data_ptr(), x.numel(),
                                              plan["threads"], _stream(x))
    launches["field"] += 1
    _raise_on(err, "field inv")
    return out


def open_column(pos: int) -> int:
    """csrc/field.cu ``open_column``: the column of a 32-column k-step whose
    power byte the table stores at position ``pos`` of a plane's 32 bytes
    (lane t's two B registers are the bytes from 8t)."""
    t, hi, e = pos >> 3, (pos >> 2) & 1, pos & 3
    return 16 * hi + 2 * t + (e & 1) + 8 * (e >> 1)


def field_open_plan(shapes: list, n: int) -> dict:
    """How one launch of ``field_open_kernel`` takes the openings of batches
    of (rows, k) ``shapes`` (rows coefficient rows of n columns at k points):
    batch b's ``groups[b]`` blocks of OPEN_ROWS rows start at block
    ``group0[b]`` of the grid's x, whose y is the ``slices`` column slices of
    OPEN_CHUNK columns, each walked in stages of OPEN_KS columns; a slice's
    values of batch b, (2, k, rows), start at word ``out[b]`` of ``total``.
    ``ntiles[b]`` n-tiles of 8 of its 2k power rows and ``mtiles[b]`` (per
    group) m-tiles of 16 rows are the warps with work; the power table's rows
    are ``n_pad`` words; ``launches``: the table, the product and, with more
    than one slice, their sum."""
    if not 1 <= len(shapes) <= OPEN_MAX_BATCHES:
        raise ValueError(f"field open: {len(shapes)} batches (1 to {OPEN_MAX_BATCHES} a launch)")
    if n < 2 or n % 2:
        raise ValueError(f"field open: {n} columns (the bulk copies take an even number, at least 2)")
    groups, group0, out, ntiles, mtiles = [], [], [], [], []
    blocks = total = 0
    for rows, k in shapes:
        if rows < 1 or not 1 <= k <= OPEN_MAX_POINTS:
            raise ValueError(f"field open: {rows} rows at {k} points (1 to {OPEN_MAX_POINTS} points)")
        groups.append(-(-rows // OPEN_ROWS))
        group0.append(blocks)
        out.append(total)
        ntiles.append(-(-2 * k // 8))
        mtiles.append([-(-min(OPEN_ROWS, rows - g * OPEN_ROWS) // 16) for g in range(groups[-1])])
        blocks += groups[-1]
        total += 2 * k * rows
    slices = -(-n // OPEN_CHUNK)
    if blocks >= 1 << 31 or slices > 65535:
        raise ValueError(f"field open: a grid of {blocks} x {slices} blocks")
    return {"groups": groups, "group0": group0, "blocks": blocks, "out": out, "total": total,
            "ntiles": ntiles, "mtiles": mtiles, "slices": slices,
            "slice_cols": min(OPEN_CHUNK, n), "n_pad": -(-n // OPEN_KS) * OPEN_KS,
            "launches": 2 if slices == 1 else 3}


def _aligned(t: torch.Tensor) -> bool:
    """The tensor's first word is 16-byte aligned (what a bulk copy needs)."""
    return t.data_ptr() % 16 == 0


def field_open_table(z_re: torch.Tensor, z_im: torch.Tensor, n: int) -> torch.Tensor:
    """Launch ``field_open_table_kernel``: the power table of the k ext points
    (z_re, z_im) over n columns, (2k, n_pad) words (n_pad = n rounded up to
    whole stages): row 2j + part of point j holds the byte planes of part
    (0 real, 1 imaginary) of z_j^c, each 32-column group's 256 bytes plane
    by plane in the order the product reads them (csrc/field.cu
    ``open_column``), zero from column n on; ``prove.open_table_plain`` is
    its plain version."""
    _check(z_re, "z_re")
    _check(z_im, "z_im")
    if (z_re.dim() != 1 or z_re.shape != z_im.shape or not z_re.is_contiguous()
            or not z_im.is_contiguous() or z_re.shape[0] < 1 or n < 1):
        raise ValueError(f"field open table: points {tuple(z_re.shape)} and {tuple(z_im.shape)} "
                         f"over {n} columns")
    n_pad = -(-n // OPEN_KS) * OPEN_KS
    table = torch.empty((2 * z_re.shape[0], n_pad), dtype=torch.int64, device=z_re.device)
    err = _libraries()["field"].elp_field_open_table(z_re.data_ptr(), z_im.data_ptr(),
                                                     z_re.shape[0], n, n_pad, table.data_ptr(),
                                                     _stream(z_re))
    launches["field"] += 1
    _raise_on(err, "field open table")
    return table


def open_entries(point_rows: list) -> list:
    """The openings' table of batches: (batch, first point, points) entries of
    at most OPEN_MAX_POINTS points, a batch's points in order (a batch without
    points has none)."""
    return [(b, j, len(rows[j : j + OPEN_MAX_POINTS])) for b, rows in enumerate(point_rows)
            for j in range(0, len(rows), OPEN_MAX_POINTS)]


def field_open_plans(rows: list, point_rows: list, n: int) -> list:
    """The product launches of ``field_open`` for batches of ``rows[b]``
    coefficient rows at points ``point_rows[b]``: (entries, plan) for each
    group of at most OPEN_MAX_BATCHES entries of ``open_entries`` (a batch
    without rows takes none), in order; one table launch goes before them, so
    a call launches 1 + sum(plan["launches"] - 1) kernels."""
    entries = [(b, j, kb) for b, j, kb in open_entries(point_rows) if rows[b]]
    groups = [entries[g : g + OPEN_MAX_BATCHES] for g in range(0, len(entries), OPEN_MAX_BATCHES)]
    return [(group, field_open_plan([(rows[b], kb) for b, _, kb in group], n)) for group in groups]


def field_open(coeffs: list, z_re: torch.Tensor, z_im: torch.Tensor, point_rows: list) -> list:
    """Launch ``field_open_table_kernel``, then ``field_open_kernel`` (and
    ``field_open_sum_kernel`` over its slices) once for each group of
    ``field_open_plans``: the values of each batch's
    (rows, n) coefficient rows ``coeffs[b]`` at its points z[i] for i in
    ``point_rows[b]`` (indices into the ext points (z_re, z_im)), as one
    ((k, rows) real, (k, rows) imaginary) pair a batch."""
    for i, t in enumerate([*coeffs, z_re, z_im]):
        _check(t, f"field open argument {i}")
    if (z_re.dim() != 1 or z_re.shape != z_im.shape or not z_re.is_contiguous()
            or not z_im.is_contiguous() or len(coeffs) != len(point_rows)):
        raise ValueError(f"field open: points {tuple(z_re.shape)} and {tuple(z_im.shape)}, "
                         f"{len(coeffs)} batches and {len(point_rows)} point lists")
    dev = z_re.device
    n = coeffs[0].shape[1] if coeffs and coeffs[0].dim() == 2 else -1
    for c, rows_of in zip(coeffs, point_rows):
        if (c.dim() != 2 or c.shape[1] != n or (n > 1 and c.stride(1) != 1) or c.device != dev
                or (c.shape[0] > 1 and (c.stride(0) < n or c.stride(0) % 2)) or not _aligned(c)
                or any(not 0 <= i < z_re.shape[0] for i in rows_of)):
            raise ValueError(f"field open: coefficients {tuple(c.shape)} with strides {c.stride()} "
                             f"on {c.device} at points {list(rows_of)} of {z_re.shape[0]} (rows of "
                             f"{n} words, even row strides, 16-byte aligned)")
    results = [None] * len(coeffs)
    launches_of = field_open_plans([c.shape[0] for c in coeffs], point_rows, n)
    for b in set(range(len(coeffs))) - {b for group, _ in launches_of for b, _, _ in group}:
        empty = torch.empty((len(point_rows[b]), coeffs[b].shape[0]), dtype=torch.int64, device=dev)
        results[b] = (empty, empty.clone())
    if not launches_of:
        return results
    table = field_open_table(z_re, z_im, n)
    parts: dict = {}
    for group, plan in launches_of:
        for (b, _, _), values in zip(group, _field_open_launch(coeffs, z_re, table, point_rows,
                                                                group, plan, n)):
            parts.setdefault(b, []).append(values)
    for b, values in parts.items():
        both = values[0] if len(values) == 1 else torch.cat(values, dim=1)
        results[b] = (both[0], both[1])
    return results


def _field_open_launch(coeffs, z_re, table, point_rows, entries, plan, n) -> list:
    """One launch of ``field_open_kernel`` (and its slices' sum) over a group
    of ``field_open_plans``: each entry's values, (2, points, rows)."""
    shapes = [(coeffs[b].shape[0], kb) for b, _, kb in entries]
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    nb = len(entries)
    points = [0] * (nb * OPEN_MAX_POINTS)
    for i, (b, j, kb) in enumerate(entries):
        points[i * OPEN_MAX_POINTS : i * OPEN_MAX_POINTS + kb] = point_rows[b][j : j + kb]
    out = torch.empty(plan["total"], dtype=torch.int64, device=z_re.device)
    partial = (out if plan["slices"] == 1 else
               torch.empty((plan["slices"], plan["total"]), dtype=torch.int64, device=z_re.device))
    err = _libraries()["field"].elp_field_open(
        nb, (vp * nb)(*[coeffs[b].data_ptr() for b, _, _ in entries]),
        (ll * nb)(*[coeffs[b].stride(0) if coeffs[b].shape[0] > 1 else n for b, _, _ in entries]),
        (i32 * nb)(*[r for r, _ in shapes]), (i32 * nb)(*[kb for _, kb in shapes]),
        (i32 * len(points))(*points), (ll * nb)(*plan["out"]), (i32 * nb)(*plan["group0"]),
        plan["blocks"], plan["slices"], z_re.shape[0], n, plan["n_pad"], table.data_ptr(),
        plan["total"], partial.data_ptr(), out.data_ptr(), _stream(z_re))
    launches["field"] += plan["launches"] - 1
    _raise_on(err, "field open")
    return [out[at : at + 2 * kb * rows].view(2, kb, rows)
            for (rows, kb), at in zip(shapes, plan["out"])]


def perm_stage_layout(chunks: int, chunk: int) -> list:
    """The stages of one tile of ``perm_quotient_kernel``'s ring, in the order
    the producer fills them: each a list of (slot, source, row), the tile's
    segment of row ``row`` of ``source`` ("x", "l0", "zs", "wires" or "sigma")
    copied into slot ``slot``.  The head holds x, l0 and each challenge's Z;
    chunk k takes ceil(chunk / PERM_PAIRS) stages of wire rows (slot r) and
    sigma rows (slot PERM_PAIRS + r), its last stage, but for the last
    chunk's, also each challenge j's chain row k + 1 (Z row j m + 1 + k) in
    slot 2 PERM_PAIRS + j."""
    m = chunks
    layout = [[(0, "x", 0), (1, "l0", 0)]
              + [(2 + j, "zs", j * m) for j in range(PERM_CHALLENGES)]]
    per_chunk = -(-chunk // PERM_PAIRS)
    for k in range(m):
        for q in range(per_chunk):
            i0 = q * PERM_PAIRS
            cols = range(k * chunk + i0, k * chunk + min(chunk, i0 + PERM_PAIRS))
            stage = ([(r, "wires", c) for r, c in enumerate(cols)]
                     + [(PERM_PAIRS + r, "sigma", c) for r, c in enumerate(cols)])
            if q == per_chunk - 1 and k + 1 < m:
                stage += [(2 * PERM_PAIRS + j, "zs", j * m + 1 + k) for j in range(PERM_CHALLENGES)]
            layout.append(stage)
    return layout


def perm_quotient_plan(wires, sigma, zs, x, l0, k_shifts, betas, gammas, alphas: list,
                       chunk: int, rate_bits: int, window: bool = False, sms: int = 1) -> dict:
    """How ``perm_quotient_kernel`` reads its arguments: checks what it assumes
    and returns the columns, the routed wires, the chunks, the row strides (in
    words) of the wires, the sigma rows and the Z rows, the column offset of
    the next trace row, how many alpha powers a challenge it reads, and the
    ring: ``tile`` columns a tile (min(PERM_TILE, n_lde)), ``tiles``, the
    persistent ``blocks`` (PERM_MIN_BLOCKS on each of the card's ``sms``
    multiprocessors, at most one a tile), the stages of a tile
    (``perm_stage_layout``) and the dynamic shared memory.

    ``wires`` and ``sigma`` are (routed, n_lde) views with unit column stride
    (rows of the wires' and the preprocessed LDE), ``zs`` the (2 m, n_lde) Z
    rows (Z and its m - 1 partials a challenge), ``x`` and ``l0`` dense
    (n_lde,) rows, ``k_shifts`` (routed,), ``betas`` and ``gammas`` (2,),
    ``alphas`` one dense row of at least m + 1 powers a challenge.  The rows
    arrive by bulk copies of a tile's segment, so each must start 16-byte
    aligned (an aligned first word, an even row stride).  A plan that does not
    hold raises.

    ``window``: the columns are a shard's points, views at the first computed
    column of windows whose halo holds Z at the next row (the mask is all
    ones and nothing wraps); otherwise the next row of the last columns
    wraps to the first (mask n_lde - 1)."""
    routed, n_lde = wires.shape if wires.dim() == 2 else (0, 0)
    if not MIN_TILE <= n_lde <= 1 << 30 or n_lde & (n_lde - 1):
        raise ValueError(f"perm quotient: wires of shape {tuple(wires.shape)} (a power of two of "
                         f"{MIN_TILE} to 2^30 columns)")
    if chunk < 1 or routed % chunk or routed > PERM_MAX_ROUTED or routed // chunk > PERM_MAX_CHUNKS:
        raise ValueError(f"perm quotient: {routed} routed wires in chunks of {chunk} (at most "
                         f"{PERM_MAX_ROUTED} wires, {PERM_MAX_CHUNKS} chunks)")
    m = routed // chunk
    if len(alphas) != PERM_CHALLENGES:
        raise ValueError(f"perm quotient: {len(alphas)} alpha rows, the kernel takes "
                         f"{PERM_CHALLENGES} challenges")
    shapes = [("wires", wires, (routed, n_lde)), ("sigma", sigma, (routed, n_lde)),
              ("zs", zs, (PERM_CHALLENGES * m, n_lde)), ("x", x, (n_lde,)), ("l0", l0, (n_lde,)),
              ("k_shifts", k_shifts, (routed,)), ("betas", betas, (PERM_CHALLENGES,)),
              ("gammas", gammas, (PERM_CHALLENGES,))]
    for j, a in enumerate(alphas):
        if a.dim() != 1 or a.shape[0] < m + 1:
            raise ValueError(f"perm quotient: alpha row {j} of shape {tuple(a.shape)}, the kernel "
                             f"reads {m + 1} powers")
        shapes.append((f"alpha row {j}", a, tuple(a.shape)))
    for name, t, shape in shapes:
        if tuple(t.shape) != shape or t.stride(-1) != 1 or t.dtype != torch.int64:
            raise ValueError(f"perm quotient: {name} of shape {tuple(t.shape)}, strides "
                             f"{t.stride()}, {t.dtype}, expected {shape} with unit column stride")
        if len(shape) == 2 and shape[0] > 1 and t.stride(0) < n_lde:
            raise ValueError(f"perm quotient: {name}'s rows overlap (row stride {t.stride(0)})")
        if t.device != wires.device:
            raise ValueError(f"perm quotient: {name} on {t.device}, the wires on {wires.device}")
    strides = {name: t.stride(0) if t.shape[0] > 1 else n_lde
               for name, t in (("wires", wires), ("sigma", sigma), ("zs", zs))}
    for name, t in (("wires", wires), ("sigma", sigma), ("zs", zs), ("x", x), ("l0", l0)):
        if strides.get(name, 0) % 2 or not _aligned(t):
            raise ValueError(f"perm quotient: {name}'s rows are not 16-byte aligned (row stride "
                             f"{strides.get(name, '-')}, first word at byte {t.data_ptr() % 16} "
                             f"of 16)")
    tile = min(PERM_TILE, n_lde)
    tiles = n_lde // tile
    layout = perm_stage_layout(m, chunk)
    return {"n_lde": n_lde, "routed": routed, "chunks": m, "wires_stride": strides["wires"],
            "sigma_stride": strides["sigma"], "zs_stride": strides["zs"], "next": 1 << rate_bits,
            "alpha_terms": m + 1, "mask": -1 if window else n_lde - 1, "tile": tile,
            "tiles": tiles, "blocks": min(tiles, PERM_MIN_BLOCKS * max(1, sms)), "layout": layout,
            "shared_bytes": (PERM_STAGES * PERM_STAGE_ROWS * tile + 2 * routed + PERM_STAGES) * 8
            + 4 * PERM_STAGES}


def perm_quotient(wires, sigma, zs, x, l0, k_shifts, betas, gammas, alphas: list, chunk: int,
                  rate_bits: int, window: bool = False) -> torch.Tensor:
    """Launch ``perm_quotient_kernel``: the (2, n_lde) accumulators
    sum_k alphas[j][k] * term_k of the permutation argument (term 0 is
    l0 * (Z - 1), term 1 + k chunk k's), as ``perm_quotient_plan`` reads
    the arguments (``window``: its window form)."""
    for t, name in ((wires, "wires"), (sigma, "sigma"), (zs, "zs"), (x, "x"), (l0, "l0"),
                    (k_shifts, "k_shifts"), (betas, "betas"), (gammas, "gammas")):
        _check(t, name)
    for j, a in enumerate(alphas):
        _check(a, f"alpha row {j}")
    plan = perm_quotient_plan(wires, sigma, zs, x, l0, k_shifts, betas, gammas, alphas, chunk,
                              rate_bits, window, _sms(wires))
    out = torch.empty((PERM_CHALLENGES, plan["n_lde"]), dtype=torch.int64, device=wires.device)
    err = _libraries()["field"].elp_perm_quotient(
        wires.data_ptr(), plan["wires_stride"], sigma.data_ptr(), plan["sigma_stride"],
        zs.data_ptr(), plan["zs_stride"], x.data_ptr(), l0.data_ptr(), k_shifts.data_ptr(),
        betas.data_ptr(), gammas.data_ptr(), alphas[0].data_ptr(), alphas[1].data_ptr(),
        plan["n_lde"], plan["mask"], rate_bits, plan["routed"], chunk, out.data_ptr(), plan["tile"],
        plan["blocks"], _stream(wires))
    launches["field"] += 1
    _raise_on(err, "perm quotient")
    return out


def _sms(t: torch.Tensor) -> int:
    """The multiprocessors of the card that holds ``t``."""
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def perm_z_plan(routed: int, n: int, chunk: int, challenges: int) -> dict:
    """How the three launches of csrc/field.cu's Z and partials are sized, for
    ``routed`` wires in chunks of ``chunk`` (m = routed / chunk) on an n-point
    subgroup, ``challenges`` challenges.  perm_z_kernel: blocks of
    ``threads`` columns (PERM_Z_THREADS, halved while its ``shared_bytes`` of
    dynamic shared memory, challenges * m words of num and of den a thread,
    pass PERM_Z_SHARED_TARGET: 256 up to m = 12 at two challenges, 32 at
    m = PERM_MAX_CHUNKS), ``blocks`` of them; it
    writes the block-local Z into ``z_rows`` and parks the unscaled running
    products rat_pref[k], k < m - 1, in ``parked_rows`` (row j * m + 1 + k
    takes challenge j's rat_pref[k]) of the (challenges * m, n) output, and
    each block's product into a (challenges, blocks) scratch.
    perm_z_scan_kernel: one block of ``scan_threads`` a challenge, ``run``
    block products a thread.  perm_z_fixup_kernel: a thread a column and
    challenge."""
    if n < 1 or chunk < 1 or routed < chunk or routed % chunk or routed > PERM_MAX_ROUTED:
        raise ValueError(f"perm Z: {routed} routed wires in chunks of {chunk} on {n} points (at "
                         f"most {PERM_MAX_ROUTED} wires)")
    m = routed // chunk
    if m > PERM_MAX_CHUNKS or not 1 <= challenges <= PERM_CHALLENGES:
        raise ValueError(f"perm Z: {m} chunks, {challenges} challenges (at most {PERM_MAX_CHUNKS} "
                         f"chunks, 1 to {PERM_CHALLENGES} challenges)")

    def shared(t):
        return 2 * challenges * m * t * 8

    threads = PERM_Z_THREADS
    while shared(threads) > PERM_Z_SHARED_TARGET:  # m <= PERM_MAX_CHUNKS stops at 32 or more
        threads //= 2
    blocks = -(-n // threads)
    if blocks >= 1 << 31:
        raise ValueError(f"perm Z: a grid of {blocks} blocks")
    return {"m": m, "threads": threads, "blocks": blocks, "shared_bytes": shared(threads),
            "scan_threads": PERM_Z_SCAN_THREADS, "run": max(1, -(-blocks // PERM_Z_SCAN_THREADS)),
            "z_rows": [j * m for j in range(challenges)],
            "parked_rows": [j * m + 1 + k for j in range(challenges) for k in range(m - 1)],
            "launches": 3}


def perm_z(wires, sigma, omega, k_shifts, betas, gammas, chunk: int) -> torch.Tensor:
    """Launch ``perm_z_kernel``, ``perm_z_scan_kernel`` and
    ``perm_z_fixup_kernel``: the permutation argument's rows [Z_j, p_j0, ...,
    p_j(m-2)] of every challenge j, as one (challenges * m, n) tensor.
    ``wires`` and ``sigma`` are (routed, n) views with unit column stride
    (the routed rows of the wires, read through their row stride), ``omega``
    the (n,) subgroup, ``k_shifts`` (routed,), ``betas`` and ``gammas`` one
    word a challenge; see ``perm_z_plan``."""
    for t, name in ((wires, "wires"), (sigma, "sigma"), (omega, "omega"), (k_shifts, "k_shifts"),
                    (betas, "betas"), (gammas, "gammas")):
        _check(t, name)
    routed, n = wires.shape if wires.dim() == 2 else (0, 0)
    dev = wires.device
    _rows_view(wires, n, dev, "wires", "perm Z")
    _rows_view(sigma, n, dev, "sigma", "perm Z")
    if sigma.shape[0] != routed:
        raise ValueError(f"perm Z: {sigma.shape[0]} sigma rows for {routed} routed wires")
    challenges = betas.shape[0] if betas.dim() == 1 else 0
    plan = perm_z_plan(routed, n, chunk, challenges)
    _dense_row(omega, n, dev, "omega", "perm Z")
    _dense_row(k_shifts, routed, dev, "k_shifts", "perm Z")
    _dense_row(betas, challenges, dev, "betas", "perm Z")
    _dense_row(gammas, challenges, dev, "gammas", "perm Z")
    out = torch.empty((challenges * plan["m"], n), dtype=torch.int64, device=dev)
    totals = torch.empty((challenges, plan["blocks"]), dtype=torch.int64, device=dev)
    err = _libraries()["field"].elp_perm_z(
        wires.data_ptr(), wires.stride(0) if routed > 1 else n, sigma.data_ptr(),
        sigma.stride(0) if routed > 1 else n, omega.data_ptr(), k_shifts.data_ptr(),
        betas.data_ptr(), gammas.data_ptr(), n, routed, chunk, challenges, out.data_ptr(),
        totals.data_ptr(), plan["threads"], plan["blocks"], plan["shared_bytes"], plan["run"],
        plan["scan_threads"], _stream(wires))
    launches["field"] += plan["launches"]
    _raise_on(err, "perm Z")
    return out


def neighbour_columns(n_lde: int, offset: int, rate_bits: int) -> torch.Tensor:
    """The LDE column that ``csrc/gates.cu`` reads for trace row r + offset at
    each column x: (x + offset * 2^rate_bits) mod n_lde, as WireView::at
    computes it (n_lde a power of two, so the kernel masks)."""
    return (torch.arange(n_lde, dtype=torch.int64) + offset * (1 << rate_bits)) & (n_lde - 1)


def gate_quotient_plan(wires_lde, rows: dict, apow_rows: list, accs: list,
                       num_constraints: int) -> tuple:
    """How ``csrc/gates.cu`` is launched for one gate: checks what the kernels
    assume of their arguments and returns (n_lde, the wires' row stride in
    words).

    ``wires_lde`` is (num_wires, n_lde) with unit column stride; ``rows`` the
    named (n_lde,) rows (selector, constant columns), ``accs`` one (n_lde,)
    accumulator a challenge and ``apow_rows`` its (num_constraints,) alpha
    powers: all dense 1-D tensors, ``GATES_CHALLENGES`` of each.  The kernels
    update the accumulators in place, so no accumulator may share a word with
    another or with an input."""
    if wires_lde.dim() != 2 or wires_lde.stride(1) != 1 or wires_lde.stride(0) < wires_lde.shape[1]:
        raise ValueError(f"gate quotient: wires of shape {tuple(wires_lde.shape)}, strides "
                         f"{wires_lde.stride()}")
    n_lde = wires_lde.shape[1]
    if n_lde < 1 or n_lde & (n_lde - 1):
        raise ValueError(f"gate quotient: {n_lde} columns is not a power of two")
    if len(apow_rows) != GATES_CHALLENGES or len(accs) != GATES_CHALLENGES:
        raise ValueError(f"gate quotient: {len(apow_rows)} alpha rows and {len(accs)} accumulators, "
                         f"the kernels take {GATES_CHALLENGES} challenges")
    for name, t, length in ([(k, v, n_lde) for k, v in rows.items()]
                            + [(f"acc {j}", a, n_lde) for j, a in enumerate(accs)]
                            + [(f"alpha row {j}", a, num_constraints)
                               for j, a in enumerate(apow_rows)]):
        if tuple(t.shape) != (length,) or (length > 1 and t.stride(0) != 1):
            raise ValueError(f"gate quotient: {name} of shape {tuple(t.shape)}, strides "
                             f"{t.stride()}, expected a dense ({length},) row")
        if t.device != wires_lde.device or t.dtype != torch.int64:
            raise ValueError(f"gate quotient: {name} on {t.device} as {t.dtype}")
    inputs = [wires_lde, *rows.values(), *apow_rows]
    for j, a in enumerate(accs):
        for other in inputs + [b for i, b in enumerate(accs) if i != j]:
            if _overlap(a, other):
                raise ValueError(f"gate quotient: acc {j} shares words with another argument")
    return n_lde, wires_lde.stride(0)


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the words two views span (first to last element) intersect."""
    def span(t):
        last = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
        return t.data_ptr(), t.data_ptr() + 8 * (last + 1)
    (a0, a1), (b0, b1) = span(a), span(b)
    return a.numel() > 0 and b.numel() > 0 and a0 < b1 and b0 < a1


def sha_gate_plan(n_lde: int, rate_bits: int, window: bool = False) -> dict:
    """How ``sha_gate_quotient_kernel`` tiles the domain: ``SHA_TILE`` adjacent
    columns a block, one a thread; each group of 32 bit wires (a, e, w) is
    staged with the columns before the tile that its neighbours read, a and e
    3 trace rows back, w 15 (``halo_ae``, ``halo_w`` columns at 2^rate_bits
    columns a row); ``shared_bytes`` holds the alpha powers and the largest
    group.  ``staged_columns`` gives the columns a block stages.  Once the raw
    bits are read, the staged columns [lo, hi) of ``signs_ae`` (a, e: one row
    back) and ``signs_w`` (w: 2 and 15 rows back) are turned into the bits'
    signs, which the sigma words read.

    ``window``: the n_lde columns are a shard's points, the middle of a
    window whose halos hold the neighbours (at least 16 trace rows before
    them); staged and neighbour columns are then read unwrapped (mask all
    ones) relative to the first computed column."""
    if n_lde < 2 or n_lde & (n_lde - 1):
        raise ValueError(f"sha gate: {n_lde} columns is not a power of two of at least 2")
    halo_ae, halo_w = 3 << rate_bits, 15 << rate_bits
    shared = 8 * (GATES_CHALLENGES * 105 + SHA_STAGE_STRIDE * (SHA_TILE + halo_w))
    if shared > SHA_MAX_SHARED_BYTES:
        raise ValueError(f"sha gate: rate 2^{rate_bits} stages {shared} bytes a block, more than "
                         f"{SHA_MAX_SHARED_BYTES}")
    step = 1 << rate_bits
    return {"n_lde": n_lde, "tile": SHA_TILE, "blocks": -(-n_lde // SHA_TILE), "step": step,
            "halo_ae": halo_ae, "halo_w": halo_w, "shared_bytes": shared,
            "signs_ae": (halo_ae - step, halo_ae - step + SHA_TILE),
            "signs_w": (halo_w - 15 * step, halo_w - 2 * step + SHA_TILE),
            "mask": -1 if window else n_lde - 1}


def staged_columns(plan: dict, block: int, halo: int) -> torch.Tensor:
    """The LDE columns a block of ``sha_gate_plan`` stages for a group with
    ``halo``: staged column j is (x0 - halo + j) & mask, x0 the block's first
    column, and n_lde - 1 past it (only threads past n_lde read those); the
    thread of column x0 + t reads trace row offset -k at staged column t +
    halo - k * step.  In the window form a column is relative to the first
    computed one, and negative in the halo."""
    x0 = block * plan["tile"]
    cols = (torch.arange(plan["tile"] + halo, dtype=torch.int64) + x0 - halo) & plan["mask"]
    return cols.clamp(max=plan["n_lde"] - 1)


def _gate_launch(kind: str, wires_lde, rows: dict, apow_rows, accs, num_constraints, call):
    """One launch of csrc/gates.cu; it adds to the accumulators in place and
    returns them."""
    _check(wires_lde, "wires_lde")
    n_lde, stride = gate_quotient_plan(wires_lde, rows, apow_rows, accs, num_constraints)
    err = call(n_lde, stride, [a.data_ptr() for a in apow_rows], [a.data_ptr() for a in accs])
    launches["gates"] += 1
    _raise_on(err, kind)
    return accs


def sha_gate_quotient(wires_lde, layout: tuple, consts: tuple, sel, apow_rows, accs,
                      rate_bits: int, window: bool = False) -> list:
    """Launch ``sha_gate_quotient_kernel``: accs[j] += sel * sum_k apow_rows[j][k] *
    C_k in place, the SHA-256 round gate's 105 constraints in ``eval()``'s
    order; returns ``accs``.  ``layout`` is (COL_WA, COL_WE, COL_WW, A_BITS,
    E_BITS, W_BITS, CARRY_A, CARRY_E, CARRY_W); ``consts`` the four constant
    rows (K, round, schedule and segment masks).  ``window``: ``wires_lde``
    is a view at the first computed column of a window whose halos hold the
    16 trace rows before it (``sha_gate_plan``)."""
    k_t, m_round, m_sched, m_bits = consts
    rows = {"sel": sel, "k_t": k_t, "m_round": m_round, "m_sched": m_sched, "m_bits": m_bits}
    if len(layout) != 9 or max(layout[3:6]) + 32 > wires_lde.shape[0] or max(layout) >= wires_lde.shape[0]:
        raise ValueError(f"sha gate: layout {layout} for {wires_lde.shape[0]} wires")
    c_layout = (ctypes.c_int * 9)(*layout)

    def call(n_lde, stride, alphas, acc):
        plan = sha_gate_plan(n_lde, rate_bits, window)
        return _libraries()["gates"].elp_sha_gate_quotient(
            wires_lde.data_ptr(), stride, n_lde, plan["mask"], rate_bits, c_layout, k_t.data_ptr(),
            m_round.data_ptr(), m_sched.data_ptr(), m_bits.data_ptr(), sel.data_ptr(),
            *alphas, *acc, plan["halo_ae"], plan["halo_w"], _stream(wires_lde))

    return _gate_launch("sha gate", wires_lde, rows, apow_rows, accs, 105, call)


@functools.lru_cache(maxsize=None)
def _poseidon_gate_constants_on(device_index: int, consts: bytes) -> None:
    """Fill the Poseidon gate's __constant__ tables on this card, once a process."""
    with torch.cuda.device(device_index):
        err = _libraries()["gates"].elp_poseidon_gate_set_constants(
            consts, len(consts), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "poseidon gate constants")


def poseidon_gate_quotient(wires_lde, layout: tuple, consts: bytes, sel, apow_rows, accs) -> list:
    """Launch ``poseidon_gate_quotient_kernel``: accs[j] += sel * sum_k
    apow_rows[j][k] * C_k in place, the Poseidon gate's 130 constraints in
    ``eval()``'s order; returns ``accs``.  ``layout`` is (W_IN, W_OUT, W_ADV);
    ``consts`` the sponge's constant image (``ops/poseidon.py``
    ``kernel_constants``: the full rounds' constants, the sparse partial
    rounds' tables and the dense layer's circulant)."""
    if len(layout) != 3 or layout[2] + 118 > wires_lde.shape[0] or max(layout[:2]) + 12 > wires_lde.shape[0]:
        raise ValueError(f"poseidon gate: layout {layout} for {wires_lde.shape[0]} wires")
    c_layout = (ctypes.c_int * 3)(*layout)

    def call(n_lde, stride, alphas, acc):
        _poseidon_gate_constants_on(_device_index(wires_lde), consts)
        return _libraries()["gates"].elp_poseidon_gate_quotient(
            wires_lde.data_ptr(), stride, n_lde, c_layout, sel.data_ptr(), *alphas, *acc,
            GATES_THREADS, _stream(wires_lde))

    return _gate_launch("poseidon gate", wires_lde, {"sel": sel}, apow_rows, accs, 130, call)


def _dense_row(t, length: int, device, name: str, what: str) -> None:
    """``t`` must be a (length,) int64 row with unit stride on ``device``."""
    if (t.dim() != 1 or t.shape[0] != length or (length > 1 and t.stride(0) != 1)
            or t.dtype != torch.int64 or t.device != device):
        raise ValueError(f"{what}: {name} of shape {tuple(t.shape)}, strides {t.stride()}, "
                         f"{t.dtype} on {t.device}, expected a dense ({length},) row on {device}")


def _rows_view(t, n: int, device, name: str, what: str) -> None:
    """``t`` must be an (rows, n) int64 view with unit column stride and rows
    that do not overlap, on ``device``."""
    if (t.dim() != 2 or t.shape[1] != n or (n > 1 and t.stride(1) != 1)
            or (t.shape[0] > 1 and t.stride(0) < n) or t.dtype != torch.int64 or t.device != device):
        raise ValueError(f"{what}: {name} of shape {tuple(t.shape)}, strides {t.stride()}, "
                         f"{t.dtype} on {t.device}, expected ({t.shape[0] if t.dim() else '?'}, {n}) "
                         f"rows with unit column stride on {device}")


def fri_g_plan(ldes, apow, y, z, x, spec_batches, sms: int) -> dict:
    """How ``fri_g_kernel`` reads G's arguments: checks what it assumes and
    returns the columns, each batch's rows, row stride and first weight (the
    weights of P, W, Z, Q follow each other), the total rows, the specs, each
    spec's batch index, the columns of a tile, the tiles and the persistent
    blocks (one on each of the card's ``sms`` multiprocessors, at most one a
    tile).

    ``ldes`` are the four batches' (rows, n_lde) LDEs in P, W, Z, Q order;
    ``apow`` (re, im) rows of total + specs weights; ``y`` and ``z`` (re, im)
    rows of one word a spec; ``x`` the (n_lde,) coset (or a shard's window of
    it); ``spec_batches`` the index into ``ldes`` of each spec's batch.

    The rows arrive by bulk copies of a tile's segment of a row, so each
    batch's rows must be 16-byte aligned (an aligned first word, an even row
    stride) and the columns whole tiles: a tile is min(G_TILE, n_lde)
    columns, an even number.  A plan that does not hold raises."""
    if len(ldes) != G_TAGS:
        raise ValueError(f"fri G: {len(ldes)} batches, the kernel takes {G_TAGS}")
    n_lde = x.shape[0] if x.dim() == 1 else 0
    if n_lde < 1:
        raise ValueError(f"fri G: coset of shape {tuple(x.shape)}")
    tile = min(G_TILE, n_lde)
    if tile % 2 or n_lde % tile:
        raise ValueError(f"fri G: {n_lde} columns are not whole tiles of {tile} (an even number "
                         f"of at most {G_TILE})")
    dev = x.device
    rows, strides, offsets, total = [], [], [], 0
    for t, lde in enumerate(ldes):
        _rows_view(lde, n_lde, dev, f"batch {t}", "fri G")
        rows.append(lde.shape[0])
        strides.append(lde.stride(0) if lde.shape[0] > 1 else n_lde)
        offsets.append(total)
        total += lde.shape[0]
        if lde.shape[0] and (strides[-1] % 2 or not _aligned(lde)):
            raise ValueError(f"fri G: batch {t}'s rows are not 16-byte aligned (row stride "
                             f"{strides[-1]}, first word at byte {lde.data_ptr() % 16} of 16)")
    specs = len(spec_batches)
    if not 1 <= specs <= G_MAX_SPECS or total > G_MAX_ROWS:
        raise ValueError(f"fri G: {specs} specs and {total} rows (the kernel takes 1 to "
                         f"{G_MAX_SPECS} specs, at most {G_MAX_ROWS} rows)")
    if any(not 0 <= t < G_TAGS for t in spec_batches):
        raise ValueError(f"fri G: spec batches {spec_batches}")
    _dense_row(x, n_lde, dev, "x", "fri G")
    for name, pair, length in (("apow", apow, total + specs), ("y", y, specs), ("z", z, specs)):
        for part, t in zip(("re", "im"), pair):
            _dense_row(t, length, dev, f"{name} {part}", "fri G")
    tiles = n_lde // tile
    return {"n_lde": n_lde, "rows": rows, "strides": strides, "offsets": offsets, "total": total,
            "specs": specs, "spec_tag": list(spec_batches), "tile": tile, "tiles": tiles,
            "blocks": min(tiles, sms)}


def fri_g(ldes, apow, y, z, x, spec_batches) -> tuple:
    """Launch ``fri_g_kernel``: G(x) = sum_j a_{total+j} (B_{tag(j)}(x) - y_j) /
    (x - z_j) over the coset ``x``, B_t = sum_i a_{off_t+i} lde_t[i], as
    (re, im) rows of n_lde words (see ``fri_g_plan`` for the arguments)."""
    for i, t in enumerate([*ldes, *apow, *y, *z, x]):
        _check(t, f"fri G argument {i}")
    plan = fri_g_plan(ldes, apow, y, z, x, spec_batches,
                      torch.cuda.get_device_properties(x.device).multi_processor_count)
    out = torch.empty((2, plan["n_lde"]), dtype=torch.int64, device=x.device)
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    err = _libraries()["field"].elp_fri_g(
        (vp * G_TAGS)(*[t.data_ptr() for t in ldes]), (ll * G_TAGS)(*plan["strides"]),
        (i32 * G_TAGS)(*plan["rows"]), (i32 * G_MAX_SPECS)(*plan["spec_tag"]), plan["specs"],
        x.data_ptr(), apow[0].data_ptr(), apow[1].data_ptr(), y[0].data_ptr(), y[1].data_ptr(),
        z[0].data_ptr(), z[1].data_ptr(), plan["n_lde"], plan["tile"], plan["blocks"],
        out[0].data_ptr(), out[1].data_ptr(), _stream(x))
    launches["field"] += 1
    _raise_on(err, "fri G")
    return out[0], out[1]


def fri_fold_plan(re, im, w_inv, beta) -> int:
    """What ``fri_fold_kernel`` assumes of one fold's arguments: (2h,) dense
    ``re`` and ``im``, the (h,) table ``w_inv`` of w^-i, ``beta`` two
    shape-() words, all on one device.  Returns h."""
    size = re.shape[0] if re.dim() == 1 else 0
    if size < 2 or size & 1:
        raise ValueError(f"fri fold: a layer of shape {tuple(re.shape)}")
    h = size // 2
    dev = re.device
    _dense_row(re, size, dev, "re", "fri fold")
    _dense_row(im, size, dev, "im", "fri fold")
    _dense_row(w_inv, h, dev, "w_inv", "fri fold")
    for part, t in zip(("re", "im"), beta):
        if t.dim() != 0 or t.dtype != torch.int64 or t.device != dev:
            raise ValueError(f"fri fold: beta {part} of shape {tuple(t.shape)} on {t.device}")
    return h


def fri_fold(re, im, w_inv, scale: int, half: int, beta) -> tuple:
    """Launch ``fri_fold_kernel``: one fold of the ext layer (re, im) of 2h
    words into h, out[i] = (e0 + e1) half + beta (e0 - e1) w_inv[i] scale
    with e0, e1 the words i and i + h; ``scale`` and ``half`` host words,
    ``beta`` a pair of shape-() device words."""
    for t, name in ((re, "re"), (im, "im"), (w_inv, "w_inv"), (beta[0], "beta re"),
                    (beta[1], "beta im")):
        _check(t, name)
    h = fri_fold_plan(re, im, w_inv, beta)
    out = torch.empty((2, h), dtype=torch.int64, device=re.device)
    err = _libraries()["field"].elp_fri_fold(
        re.data_ptr(), im.data_ptr(), w_inv.data_ptr(), int(scale), int(half), beta[0].data_ptr(),
        beta[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(), h, FIELD_THREADS, _stream(re))
    launches["field"] += 1
    _raise_on(err, "fri fold")
    return out[0], out[1]


def generic_gate_plan(gates: list, wires_lde, pre_lde, num_sel: int, num_constants: int, lr,
                      pi_f, pi_cols, apows: list, accs: list, pi0: int, k0: int,
                      sms: int = 1) -> dict:
    """How ``generic_gate_quotient_kernel`` is launched: checks what it
    assumes and returns its parameters and its layout.

    ``gates`` are the circuit's (index, gate) pairs of the generic gates with
    constraints (``GENERIC_GATES``, each at most once); ``wires_lde`` the
    (num_wires, n_lde) LDE; ``pre_lde`` the preprocessed LDE (selector gi at
    row gi, constant column i at row num_sel + i); ``lr`` the (num_pi, n_lde)
    Lagrange rows, ``pi_f`` the public inputs and ``pi_cols`` their wire
    columns (a 1-D int64 tensor, read on the host: on the card it costs a
    synchronize); ``apows`` one row of alpha powers a challenge, read at pi0 +
    i (public input i) and k0 + k (constraint k of a gate); ``accs`` one
    (n_lde,) accumulator a challenge, updated in place.

    The layout: a tile of ``tile`` columns takes a head of ``head_rows``
    rows (``h_sel``: each gate's selector, -1 for an absent gate; from
    ``h_const`` the ``nconst`` constant rows the gates read, from ``h_lr``
    the Lagrange rows, from ``h_acc`` the accumulators) and ``stages`` wire
    stages of GEN_STAGE_ROWS rows through a ring of ``ring`` of them:
    ``stage_cols[s]`` the columns stage s holds, the ``visit`` columns in
    order, then the ``extra`` columns of public inputs at or past ``visit``
    (each once, ascending).  The tile is GEN_TILE (at most n_lde) columns and
    the ring GEN_STAGES deep; where the shared memory would pass
    GEN_MAX_SHARED_BYTES the ring gets shallower, down to 2, then the tile
    narrower, down to GEN_MIN_TILE; a block is ``threads`` = max(32, tile)
    threads, ``blocks`` of them.
    ``pi_place[i]`` is (stage, slot) of public input i's wire; ``table`` the
    ints the kernel reads: the public inputs in stage order (i | slot << 16),
    each stage's first entry in it (stages + 1), the extra columns.  Every
    row must start 16-byte aligned (an aligned first word, an even row
    stride).  A plan that does not hold raises."""
    what = "generic gates"
    _rows_view(wires_lde, wires_lde.shape[1] if wires_lde.dim() == 2 else 0, wires_lde.device,
               "wires_lde", what)
    num_wires, n_lde = wires_lde.shape
    dev = wires_lde.device
    if not MIN_TILE <= n_lde <= 1 << 30 or n_lde & (n_lde - 1):
        raise ValueError(f"{what}: wires of shape {tuple(wires_lde.shape)} (a power of two of "
                         f"{MIN_TILE} to 2^30 columns)")
    _rows_view(pre_lde, n_lde, dev, "pre_lde", what)
    params = {"arith": None, "basesum2": None, "const": None}
    for gi, g in gates:
        if g.name not in params or params[g.name] is not None:
            raise ValueError(f"{what}: gate {g.name!r} (each of {GENERIC_GATES} at most once)")
        if not 0 <= gi < num_sel:
            raise ValueError(f"{what}: selector row {gi} of {num_sel}")
        if not 0 < g.num_constraints < GEN_MAX_CONSTRAINTS:
            raise ValueError(f"{what}: {g.name} has {g.num_constraints} constraints (the kernel "
                             f"takes fewer than {GEN_MAX_CONSTRAINTS})")
        params[g.name] = (gi, g)
    arith_ops = bs_bits = bs_slots = const_slots = 0
    if params["arith"]:
        arith_ops = params["arith"][1].num_ops
        if 4 * arith_ops > num_wires or num_constants < 2:
            raise ValueError(f"{what}: {arith_ops} arithmetic ops on {num_wires} wires and "
                             f"{num_constants} constants")
    if params["basesum2"]:
        g = params["basesum2"][1]
        bs_bits, bs_slots = g.num_bits, g.num_slots
        if bs_bits > GEN_BS_MAX_BITS or GEN_BS_STRIDE * bs_slots > num_wires:
            raise ValueError(f"{what}: {bs_slots} slots of {bs_bits} bits on {num_wires} wires "
                             f"(at most {GEN_BS_MAX_BITS} bits a slot)")
    if params["const"]:
        const_slots = params["const"][1].num_slots
        if const_slots > min(num_wires, num_constants):
            raise ValueError(f"{what}: {const_slots} constant slots, {num_constants} constants")
    if num_sel + num_constants > pre_lde.shape[0] or num_constants < 1:
        raise ValueError(f"{what}: {num_sel} selectors and {num_constants} constants in "
                         f"{pre_lde.shape[0]} preprocessed rows")
    slots = max(arith_ops, bs_slots * (1 + bs_bits), const_slots)
    num_pi = pi_f.shape[0] if pi_f.dim() == 1 else -1
    if num_pi < 0 or tuple(lr.shape) != (num_pi, n_lde) or tuple(pi_cols.shape) != (num_pi,):
        raise ValueError(f"{what}: public inputs {tuple(pi_f.shape)}, Lagrange rows "
                         f"{tuple(lr.shape)}, columns {tuple(pi_cols.shape)}")
    if num_pi:
        _rows_view(lr, n_lde, dev, "lr", what)
    _dense_row(pi_f, num_pi, dev, "pi_f", what)
    if pi_cols.dtype != torch.int64 or pi_cols.device.type not in ("cpu", dev.type):
        raise ValueError(f"{what}: pi_cols as {pi_cols.dtype} on {pi_cols.device}")
    cols = [int(c) for c in pi_cols.tolist()]
    if any(not 0 <= c < num_wires for c in cols) or num_pi > 0xFFFF:
        raise ValueError(f"{what}: public-input columns {cols} of {num_wires} wires")
    if len(apows) != GATES_CHALLENGES or len(accs) != GATES_CHALLENGES:
        raise ValueError(f"{what}: {len(apows)} alpha rows and {len(accs)} accumulators, the "
                         f"kernel takes {GATES_CHALLENGES} challenges")
    for j, (a, acc) in enumerate(zip(apows, accs)):
        _dense_row(a, a.shape[0] if a.dim() == 1 else -1, dev, f"alpha row {j}", what)
        if pi0 < 0 or k0 < 0 or a.shape[0] < max(pi0 + num_pi, k0 + slots):
            raise ValueError(f"{what}: alpha row {j} of {a.shape[0]} powers, the kernel reads "
                             f"{pi0}..{pi0 + num_pi} and {k0}..{k0 + slots}")
        _dense_row(acc, n_lde, dev, f"acc {j}", what)
    rows = [("wires_lde", wires_lde), ("pre_lde", pre_lde), *([("lr", lr)] if num_pi else []),
            *((f"acc {j}", a) for j, a in enumerate(accs))]
    for name, t in rows:
        stride = t.stride(0) if t.dim() == 2 and t.shape[0] > 1 else n_lde
        if stride % 2 or not _aligned(t):
            raise ValueError(f"{what}: {name}'s rows are not 16-byte aligned (row stride {stride}, "
                             f"first word at byte {t.data_ptr() % 16} of 16)")
    # the head, and the wire stages with the public inputs' places
    visit = max(4 * arith_ops, GEN_BS_STRIDE * bs_slots, const_slots)
    nconst = max(2 if arith_ops else 0, const_slots)
    h_sel, at = [], 0
    for name in GENERIC_GATES:
        h_sel.append(at if params[name] else -1)
        at += 1 if params[name] else 0
    h_const, h_lr = at, at + nconst
    h_acc = h_lr + num_pi
    head_rows = h_acc + GATES_CHALLENGES
    extra = sorted({c for c in cols if c >= visit})
    stage_cols = ([list(range(w0, min(visit, w0 + GEN_STAGE_ROWS)))
                   for w0 in range(0, visit, GEN_STAGE_ROWS)]
                  + [extra[e0 : e0 + GEN_STAGE_ROWS] for e0 in range(0, len(extra), GEN_STAGE_ROWS)])
    wire_stages = -(-visit // GEN_STAGE_ROWS)
    pi_place = [divmod(c, GEN_STAGE_ROWS) if c < visit else
                (wire_stages + extra.index(c) // GEN_STAGE_ROWS, extra.index(c) % GEN_STAGE_ROWS)
                for c in cols]
    order = sorted(range(num_pi), key=lambda i: (pi_place[i], i))
    first = [sum(1 for i in order if pi_place[i][0] < s) for s in range(len(stage_cols) + 1)]
    table = [i | pi_place[i][1] << 16 for i in order] + first + extra

    def shared(t, ring):
        return ((ring * GEN_STAGE_ROWS * t + head_rows * t
                 + GATES_CHALLENGES * (num_pi + slots) + num_pi + ring + 1) * 8
                + 4 * (ring + 1 + len(table)))

    tile, ring = min(GEN_TILE, n_lde), GEN_STAGES
    while shared(tile, ring) > GEN_MAX_SHARED_BYTES and (ring > 2 or tile > GEN_MIN_TILE):
        if ring > 2:
            ring -= 1
        else:
            tile, ring = tile // 2, GEN_STAGES
    if shared(tile, ring) > GEN_MAX_SHARED_BYTES:
        raise ValueError(f"{what}: {num_pi} public inputs and {slots} slots need "
                         f"{shared(tile, ring)} bytes of shared memory at {tile} columns a tile")
    tiles, threads = n_lde // tile, max(32, tile)
    # blocks an SM: as many as GEN_MIN_BLOCKS of GEN_TILE threads, as the
    # shared memory allows (an SM's 228 KB, 1 KB of it reserved a block)
    per_sm = max(1, min(GEN_MIN_BLOCKS * GEN_TILE // threads,
                        228 * 1024 // (shared(tile, ring) + 1024)))
    return {"n_lde": n_lde, "wires_stride": wires_lde.stride(0), "consts_stride": pre_lde.stride(0),
            "sel": {name: p[0] for name, p in params.items() if p}, "arith_ops": arith_ops,
            "bs_bits": bs_bits, "bs_slots": bs_slots, "const_slots": const_slots,
            "visit": visit, "slots": slots, "num_pi": num_pi,
            "lr_stride": lr.stride(0) if num_pi > 1 else n_lde, "nconst": nconst,
            "h_sel": h_sel, "h_const": h_const, "h_lr": h_lr, "h_acc": h_acc,
            "head_rows": head_rows, "stage_cols": stage_cols, "stages": len(stage_cols),
            "extra": extra, "pi_place": pi_place, "table": table, "tile": tile, "tiles": tiles,
            "ring": ring, "threads": threads, "blocks": min(tiles, per_sm * max(1, sms)),
            "shared_bytes": shared(tile, ring)}


@functools.lru_cache(maxsize=64)
def _int_table(values: tuple, device: str) -> torch.Tensor:
    """The ints of a plan's table on the card, uploaded once a layout."""
    return torch.tensor(values, dtype=torch.int32, device=device)


def generic_gate_quotient(gates: list, wires_lde, pre_lde, num_sel: int, num_constants: int, lr,
                          pi_f, pi_cols, apows: list, accs: list, pi0: int, k0: int) -> None:
    """Launch ``generic_gate_quotient_kernel``: accs[j] += sum_i
    apows[j][pi0 + i] lr_i (w_{c_i} - pi_i) + sum over the generic gates of
    sel * sum_k apows[j][k0 + k] C_k, in place (see ``generic_gate_plan``;
    ``pi_cols`` is read on the host, so the prover keeps it there)."""
    for t, name in ((wires_lde, "wires_lde"), (pre_lde, "pre_lde"), (lr, "lr"), (pi_f, "pi_f"),
                    *((a, f"alpha row {j}") for j, a in enumerate(apows)),
                    *((a, f"acc {j}") for j, a in enumerate(accs))):
        _check(t, name)
    plan = generic_gate_plan(gates, wires_lde, pre_lde, num_sel, num_constants, lr, pi_f, pi_cols,
                             apows, accs, pi0, k0, _sms(wires_lde))
    if not gates and not plan["num_pi"]:
        return  # nothing to add
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    sel = (vp * 3)(*[pre_lde[plan["sel"][name]].data_ptr() if name in plan["sel"] else None
                     for name in GENERIC_GATES])
    head = (i32 * 6)(*plan["h_sel"], plan["h_const"], plan["h_lr"], plan["h_acc"])
    table = _int_table(tuple(plan["table"]), str(wires_lde.device))
    err = _libraries()["gates"].elp_generic_gate_quotient(
        wires_lde.data_ptr(), plan["wires_stride"], pre_lde[num_sel].data_ptr(),
        plan["consts_stride"], sel, plan["arith_ops"], plan["bs_bits"], plan["bs_slots"],
        plan["const_slots"], plan["nconst"], lr.data_ptr(), plan["lr_stride"], pi_f.data_ptr(),
        plan["num_pi"], table.data_ptr(), plan["stages"], len(plan["extra"]), head,
        plan["head_rows"], plan["ring"], apows[0].data_ptr(), apows[1].data_ptr(), pi0, k0, accs[0].data_ptr(),
        accs[1].data_ptr(), plan["n_lde"], plan["tile"], plan["blocks"], _stream(wires_lde))
    launches["gates"] += 1
    _raise_on(err, "generic gates")


def _sha256_words(t: torch.Tensor, name: str, width: int) -> None:
    """Raise unless ``t`` holds rows that ``csrc/sha256.cu`` reads: (...,
    width) u32 words (``torch.uint32``, or ``torch.int32`` read as such),
    contiguous, 16-byte aligned."""
    if t.dtype not in (torch.uint32, torch.int32):
        raise ValueError(f"sha256 {name}: expected torch.uint32 or torch.int32 words, got {t.dtype}")
    if t.dim() < 1 or t.shape[-1] != width:
        raise ValueError(f"sha256 {name}: expected a shape (..., {width}), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"sha256 {name}: the kernel reads contiguous rows, got strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"sha256 {name}: the kernel's 16-byte loads need a 16-byte aligned start")


@functools.lru_cache(maxsize=None)
def _sha256_constants_on(lib, device_index: int) -> None:
    """Fill ``csrc/sha256.cu``'s __constant__ table on this card, once a
    library (``tools/field_variants.py`` loads edited copies) and card."""
    from .sha256 import kernel_constants

    image = kernel_constants()
    with torch.cuda.device(device_index):
        err = lib.elp_sha256_set_constants(image, len(image), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "sha256 constants")


def _sha256_launch(entry: str, a: torch.Tensor, b: torch.Tensor, names: tuple, widths: tuple):
    """One launch of ``entry`` over the rows of ``a`` and ``b`` -> (..., 8) torch.uint32."""
    for t, name, width in zip((a, b), names, widths):
        _sha256_words(t, name, width)
    if a.shape[:-1] != b.shape[:-1] or a.device != b.device:
        raise ValueError(f"sha256: {names[0]} {tuple(a.shape)} on {a.device} and {names[1]} "
                         f"{tuple(b.shape)} on {b.device} are not rows of one batch")
    if a.device.type != "cuda":
        raise ValueError(f"sha256: expected CUDA tensors, got {a.device}")
    out = torch.empty((*a.shape[:-1], 8), dtype=torch.uint32, device=a.device)
    n = out.numel() // 8
    if n == 0:
        return out
    lib = _libraries()["sha256"]
    _sha256_constants_on(lib, _device_index(a))
    err = getattr(lib, entry)(a.data_ptr(), b.data_ptr(), n, out.data_ptr(), SHA256_THREADS,
                              _stream(out))
    launches["sha256"] += 1
    _raise_on(err, entry)
    return out


def sha256_compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """Launch ``sha256_compress_kernel``: the SHA-256 compression of each row,
    state (..., 8) and block (..., 16) big-endian u32 words -> (..., 8)."""
    return _sha256_launch("elp_sha256_compress", state, block, ("state", "block"), (8, 16))


def sha256_two_to_one(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Launch ``sha256_two_to_one_kernel``: the SHA-256 of each 64-byte row
    left || right, (..., 8) and (..., 8) big-endian u32 words -> (..., 8)."""
    return _sha256_launch("elp_sha256_two_to_one", left, right, ("left", "right"), (8, 8))
