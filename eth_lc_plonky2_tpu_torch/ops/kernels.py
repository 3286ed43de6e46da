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
SOURCES = ("ntt.cu", "poseidon.cu", "field.cu", "gates.cu")
HEADERS = ("goldilocks.cuh", "poseidon.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

NTT_THREADS = 256
POSEIDON_THREADS = 256  # csrc/poseidon.cu: __launch_bounds__(256, ...), the most it takes
FIELD_THREADS = 256  # csrc/field.cu: __launch_bounds__(256)
FIELD_OPS = {"add": 0, "sub": 1, "mul": 2}  # csrc/field.cu: OP_ADD, OP_SUB, OP_MUL
FIELD_INV_RUN = 16  # csrc/field.cu: INV_RUN, the words a thread inverts together
# csrc/field.cu's G kernel: G_TAGS batches, G_MAX_SPECS specs, G_MAX_ROWS rows in all
G_TAGS = 4
G_MAX_SPECS = 16
G_MAX_ROWS = 2048
# csrc/field.cu's openings: OPEN_WARPS warps a block, each a point and
# OPEN_ROWS rows, 16 to OPEN_MAX_COLS columns a lane a slice of the columns
OPEN_WARPS = 8
OPEN_ROWS = 4
OPEN_MAX_COLS = 128
OPEN_MIN_COLS = 16
OPEN_MIN_BLOCKS = 2 * 132  # two blocks for each of the H100's 132 SMs, where the columns allow
# csrc/field.cu's permutation terms: PERM_CHALLENGES, PERM_MAX_ROUTED, PERM_MAX_CHUNKS
PERM_CHALLENGES = 2
PERM_MAX_ROUTED = 256
PERM_MAX_CHUNKS = 64
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
# gate, at most GEN_BS_MAX_BITS bits a BaseSum2Gate slot of GEN_BS_STRIDE wires
GEN_MAX_CONSTRAINTS = 256
GEN_BS_MAX_BITS = 32
GEN_BS_STRIDE = 33
GENERIC_GATES = ("arith", "basesum2", "const")
GEN_MAX_SHARED_BYTES = 48 * 1024

launches = {"ntt": 0, "poseidon": 0, "field": 0, "gates": 0}
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
                  "elp_field_open": [vp, ll, ll, ll, vp, vp, i32, i32, ll, i32, ll, ll, vp, vp],
                  "elp_field_open_sum": [vp, ll, ll, vp, i32, vp],
                  "elp_perm_quotient": [vp, ll, vp, ll, vp, ll, vp, vp, vp, vp, vp, vp, vp, ll,
                                        i32, i32, i32, vp, i32, vp],
                  "elp_perm_z": [vp, ll, vp, ll, vp, vp, vp, vp, ll, i32, i32, i32, vp, vp, i32, ll,
                                 ll, ll, i32, vp],
                  "elp_fri_g": [ctypes.POINTER(vp), ctypes.POINTER(ll), ctypes.POINTER(i32),
                                ctypes.POINTER(i32), i32, vp, vp, vp, vp, vp, vp, vp, ll, vp, vp,
                                i32, vp],
                  "elp_fri_fold": [vp, vp, vp, ctypes.c_ulonglong, ctypes.c_ulonglong, vp, vp, vp,
                                   vp, ll, i32, vp]},
        "gates": {"elp_sha_gate_quotient": [vp, ll, ll, i32, ctypes.POINTER(i32), vp, vp, vp, vp,
                                            vp, vp, vp, vp, vp, i32, i32, vp],
                  "elp_poseidon_gate_set_constants": [vp, ll, vp],
                  "elp_poseidon_gate_quotient": [vp, ll, ll, ctypes.POINTER(i32), vp, vp, vp, vp,
                                                 vp, i32, vp],
                  "elp_generic_gate_quotient": [vp, ll, vp, ll, vp, vp, vp, i32, i32, i32, i32, vp,
                                                ll, vp, vp, i32, vp, vp, i32, i32, vp, vp, ll, i32,
                                                vp]},
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


def field_open_plan(rows: int, n: int, k: int) -> dict:
    """How ``field_open_kernel`` tiles the evaluation of (rows, n) coefficients
    at k points: ``points_per_block`` warps a row subgroup take one point
    each, a block covers ``rows_per_block`` rows of ``row_groups`` and
    ``32 * cols`` columns of ``slices``; ``launches`` is 2 when the slices'
    partial sums need the second, summing launch, else 1.  The columns a
    lane takes shrink (to OPEN_MIN_COLS) until the grid has OPEN_MIN_BLOCKS
    blocks or the columns run out."""
    if rows < 1 or n < 1 or k < 1:
        raise ValueError(f"field open: {rows} rows of {n} coefficients at {k} points")
    ppb = min(k, OPEN_WARPS)
    rows_per_block = (OPEN_WARPS // ppb) * OPEN_ROWS
    row_groups = -(-rows // rows_per_block)
    point_groups = -(-k // ppb)
    cols = OPEN_MAX_COLS
    while cols > OPEN_MIN_COLS and row_groups * point_groups * -(-n // (32 * cols)) < OPEN_MIN_BLOCKS:
        cols //= 2
    cols = min(cols, -(-n // 32))
    slices = -(-n // (32 * cols))
    if slices * row_groups >= 1 << 31 or point_groups > 65535:
        raise ValueError(f"field open: a grid of {slices * row_groups} x {point_groups} blocks")
    return {"points_per_block": ppb, "rows_per_block": rows_per_block, "row_groups": row_groups,
            "point_groups": point_groups, "cols": cols, "slices": slices,
            "launches": 1 if slices == 1 else 2}


def field_open(coeffs: torch.Tensor, z_re: torch.Tensor, z_im: torch.Tensor) -> tuple:
    """Launch ``field_open_kernel`` (and ``field_open_sum_kernel`` over its
    slices): the values of the (rows, n) coefficient rows at the k ext points
    (z_re[j], z_im[j]), as (k, rows) real and imaginary words."""
    for t, name in ((coeffs, "coeffs"), (z_re, "z_re"), (z_im, "z_im")):
        _check(t, name)
    if (coeffs.dim() != 2 or coeffs.stride(1) != 1 or coeffs.stride(0) < coeffs.shape[1]
            or z_re.dim() != 1 or z_re.shape != z_im.shape or not z_re.is_contiguous()
            or not z_im.is_contiguous() or len({coeffs.device, z_re.device, z_im.device}) != 1):
        raise ValueError(f"field open: coefficients {tuple(coeffs.shape)} with strides "
                         f"{coeffs.stride()}, points {tuple(z_re.shape)} and {tuple(z_im.shape)}")
    rows, n = coeffs.shape
    k = z_re.shape[0]
    if rows == 0 or k == 0:
        empty = torch.empty((k, rows), dtype=torch.int64, device=coeffs.device)
        return empty, empty.clone()
    plan = field_open_plan(rows, n, k)
    lib = _libraries()["field"]
    partial = torch.empty((plan["slices"], 2, k, rows), dtype=torch.int64, device=coeffs.device)
    err = lib.elp_field_open(coeffs.data_ptr(), coeffs.stride(0), rows, n, z_re.data_ptr(),
                             z_im.data_ptr(), k, plan["points_per_block"], plan["slices"],
                             plan["cols"], plan["row_groups"], plan["point_groups"],
                             partial.data_ptr(), _stream(coeffs))
    launches["field"] += 1
    _raise_on(err, "field open")
    if plan["slices"] == 1:
        return partial[0, 0], partial[0, 1]
    out = torch.empty((2, k, rows), dtype=torch.int64, device=coeffs.device)
    err = lib.elp_field_open_sum(partial.data_ptr(), plan["slices"], out.numel(), out.data_ptr(),
                                 FIELD_THREADS, _stream(coeffs))
    launches["field"] += 1
    _raise_on(err, "field open sum")
    return out[0], out[1]


def perm_quotient_plan(wires, sigma, zs, x, l0, k_shifts, betas, gammas, alphas: list,
                       chunk: int, rate_bits: int) -> dict:
    """How ``perm_quotient_kernel`` reads its arguments: checks what it assumes
    and returns the columns, the routed wires, the chunks, the row strides (in
    words) of the wires, the sigma rows and the Z rows, the column offset of
    the next trace row and how many alpha powers a challenge it reads.

    ``wires`` and ``sigma`` are (routed, n_lde) views with unit column stride
    (rows of the wires' and the preprocessed LDE), ``zs`` the (2 m, n_lde) Z
    rows (Z and its m - 1 partials a challenge), ``x`` and ``l0`` dense
    (n_lde,) rows, ``k_shifts`` (routed,), ``betas`` and ``gammas`` (2,),
    ``alphas`` one dense row of at least m + 1 powers a challenge."""
    routed, n_lde = wires.shape if wires.dim() == 2 else (0, 0)
    if n_lde < 1 or n_lde & (n_lde - 1):
        raise ValueError(f"perm quotient: wires of shape {tuple(wires.shape)}")
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
    return {"n_lde": n_lde, "routed": routed, "chunks": m, "wires_stride": wires.stride(0),
            "sigma_stride": sigma.stride(0), "zs_stride": zs.stride(0), "next": 1 << rate_bits,
            "alpha_terms": m + 1}


def perm_quotient(wires, sigma, zs, x, l0, k_shifts, betas, gammas, alphas: list, chunk: int,
                  rate_bits: int) -> torch.Tensor:
    """Launch ``perm_quotient_kernel``: the (2, n_lde) accumulators
    sum_k alphas[j][k] * term_k of the permutation argument (term 0 is
    l0 * (Z - 1), term 1 + k chunk k's), as ``perm_quotient_plan`` reads
    the arguments."""
    for t, name in ((wires, "wires"), (sigma, "sigma"), (zs, "zs"), (x, "x"), (l0, "l0"),
                    (k_shifts, "k_shifts"), (betas, "betas"), (gammas, "gammas")):
        _check(t, name)
    for j, a in enumerate(alphas):
        _check(a, f"alpha row {j}")
    plan = perm_quotient_plan(wires, sigma, zs, x, l0, k_shifts, betas, gammas, alphas, chunk,
                              rate_bits)
    out = torch.empty((PERM_CHALLENGES, plan["n_lde"]), dtype=torch.int64, device=wires.device)
    err = _libraries()["field"].elp_perm_quotient(
        wires.data_ptr(), plan["wires_stride"], sigma.data_ptr(), plan["sigma_stride"],
        zs.data_ptr(), plan["zs_stride"], x.data_ptr(), l0.data_ptr(), k_shifts.data_ptr(),
        betas.data_ptr(), gammas.data_ptr(), alphas[0].data_ptr(), alphas[1].data_ptr(),
        plan["n_lde"], rate_bits, plan["routed"], chunk, out.data_ptr(), FIELD_THREADS,
        _stream(wires))
    launches["field"] += 1
    _raise_on(err, "perm quotient")
    return out


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


def sha_gate_plan(n_lde: int, rate_bits: int) -> dict:
    """How ``sha_gate_quotient_kernel`` tiles the domain: ``SHA_TILE`` adjacent
    columns a block, one a thread; each group of 32 bit wires (a, e, w) is
    staged with the columns before the tile that its neighbours read, a and e
    3 trace rows back, w 15 (``halo_ae``, ``halo_w`` columns at 2^rate_bits
    columns a row); ``shared_bytes`` holds the alpha powers and the largest
    group.  ``staged_columns`` gives the columns a block stages.  Once the raw
    bits are read, the staged columns [lo, hi) of ``signs_ae`` (a, e: one row
    back) and ``signs_w`` (w: 2 and 15 rows back) are turned into the bits'
    signs, which the sigma words read."""
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
            "signs_w": (halo_w - 15 * step, halo_w - 2 * step + SHA_TILE)}


def staged_columns(plan: dict, block: int, halo: int) -> torch.Tensor:
    """The LDE columns a block of ``sha_gate_plan`` stages for a group with
    ``halo``: staged column j is (x0 - halo + j) mod n_lde, x0 the block's
    first column; the thread of column x0 + t reads trace row offset -k at
    staged column t + halo - k * step."""
    x0 = block * plan["tile"]
    return (torch.arange(plan["tile"] + halo, dtype=torch.int64) + x0 - halo) & (plan["n_lde"] - 1)


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
                      rate_bits: int) -> list:
    """Launch ``sha_gate_quotient_kernel``: accs[j] += sel * sum_k apow_rows[j][k] *
    C_k in place, the SHA-256 round gate's 105 constraints in ``eval()``'s
    order; returns ``accs``.  ``layout`` is (COL_WA, COL_WE, COL_WW, A_BITS,
    E_BITS, W_BITS, CARRY_A, CARRY_E, CARRY_W); ``consts`` the four constant
    rows (K, round, schedule and segment masks)."""
    k_t, m_round, m_sched, m_bits = consts
    rows = {"sel": sel, "k_t": k_t, "m_round": m_round, "m_sched": m_sched, "m_bits": m_bits}
    if len(layout) != 9 or max(layout[3:6]) + 32 > wires_lde.shape[0] or max(layout) >= wires_lde.shape[0]:
        raise ValueError(f"sha gate: layout {layout} for {wires_lde.shape[0]} wires")
    c_layout = (ctypes.c_int * 9)(*layout)

    def call(n_lde, stride, alphas, acc):
        plan = sha_gate_plan(n_lde, rate_bits)
        return _libraries()["gates"].elp_sha_gate_quotient(
            wires_lde.data_ptr(), stride, n_lde, rate_bits, c_layout, k_t.data_ptr(),
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


def fri_g_plan(ldes, apow, y, z, x, spec_batches) -> dict:
    """How ``fri_g_kernel`` reads G's arguments: checks what it assumes and
    returns the columns, each batch's rows, row stride and first weight (the
    weights of P, W, Z, Q follow each other), the total rows, the specs and
    each spec's batch index.

    ``ldes`` are the four batches' (rows, n_lde) LDEs in P, W, Z, Q order;
    ``apow`` (re, im) rows of total + specs weights; ``y`` and ``z`` (re, im)
    rows of one word a spec; ``x`` the (n_lde,) coset; ``spec_batches`` the
    index into ``ldes`` of each spec's batch."""
    if len(ldes) != G_TAGS:
        raise ValueError(f"fri G: {len(ldes)} batches, the kernel takes {G_TAGS}")
    n_lde = x.shape[0] if x.dim() == 1 else 0
    if n_lde < 1:
        raise ValueError(f"fri G: coset of shape {tuple(x.shape)}")
    dev = x.device
    rows, strides, offsets, total = [], [], [], 0
    for t, lde in enumerate(ldes):
        _rows_view(lde, n_lde, dev, f"batch {t}", "fri G")
        rows.append(lde.shape[0])
        strides.append(lde.stride(0) if lde.shape[0] > 1 else n_lde)
        offsets.append(total)
        total += lde.shape[0]
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
    return {"n_lde": n_lde, "rows": rows, "strides": strides, "offsets": offsets, "total": total,
            "specs": specs, "spec_tag": list(spec_batches)}


def fri_g(ldes, apow, y, z, x, spec_batches) -> tuple:
    """Launch ``fri_g_kernel``: G(x) = sum_j a_{total+j} (B_{tag(j)}(x) - y_j) /
    (x - z_j) over the coset ``x``, B_t = sum_i a_{off_t+i} lde_t[i], as
    (re, im) rows of n_lde words (see ``fri_g_plan`` for the arguments)."""
    for i, t in enumerate([*ldes, *apow, *y, *z, x]):
        _check(t, f"fri G argument {i}")
    plan = fri_g_plan(ldes, apow, y, z, x, spec_batches)
    out = torch.empty((2, plan["n_lde"]), dtype=torch.int64, device=x.device)
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    err = _libraries()["field"].elp_fri_g(
        (vp * G_TAGS)(*[t.data_ptr() for t in ldes]), (ll * G_TAGS)(*plan["strides"]),
        (i32 * G_TAGS)(*plan["rows"]), (i32 * G_MAX_SPECS)(*plan["spec_tag"]), plan["specs"],
        x.data_ptr(), apow[0].data_ptr(), apow[1].data_ptr(), y[0].data_ptr(), y[1].data_ptr(),
        z[0].data_ptr(), z[1].data_ptr(), plan["n_lde"], out[0].data_ptr(), out[1].data_ptr(),
        FIELD_THREADS, _stream(x))
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
                      pi_f, pi_cols, apows: list, accs: list, pi0: int, k0: int) -> dict:
    """How ``generic_gate_quotient_kernel`` is launched: checks what it
    assumes and returns its parameters.

    ``gates`` are the circuit's (index, gate) pairs of the generic gates with
    constraints (``GENERIC_GATES``, each at most once); ``wires_lde`` the
    (num_wires, n_lde) LDE; ``pre_lde`` the preprocessed LDE (selector gi at
    row gi, constant column i at row num_sel + i); ``lr`` the (num_pi, n_lde)
    Lagrange rows, ``pi_f`` the public inputs and ``pi_cols`` their wire
    columns; ``apows`` one row of alpha powers a challenge, read at pi0 + i
    (public input i) and k0 + k (constraint k of a gate); ``accs`` one
    (n_lde,) accumulator a challenge, updated in place."""
    what = "generic gates"
    _rows_view(wires_lde, wires_lde.shape[1] if wires_lde.dim() == 2 else 0, wires_lde.device,
               "wires_lde", what)
    num_wires, n_lde = wires_lde.shape
    dev = wires_lde.device
    if n_lde < 1:
        raise ValueError(f"{what}: wires of shape {tuple(wires_lde.shape)}")
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
    _dense_row(pi_cols, num_pi, dev, "pi_cols", what)
    if len(apows) != GATES_CHALLENGES or len(accs) != GATES_CHALLENGES:
        raise ValueError(f"{what}: {len(apows)} alpha rows and {len(accs)} accumulators, the "
                         f"kernel takes {GATES_CHALLENGES} challenges")
    for j, (a, acc) in enumerate(zip(apows, accs)):
        _dense_row(a, a.shape[0] if a.dim() == 1 else -1, dev, f"alpha row {j}", what)
        if pi0 < 0 or k0 < 0 or a.shape[0] < max(pi0 + num_pi, k0 + slots):
            raise ValueError(f"{what}: alpha row {j} of {a.shape[0]} powers, the kernel reads "
                             f"{pi0}..{pi0 + num_pi} and {k0}..{k0 + slots}")
        _dense_row(acc, n_lde, dev, f"acc {j}", what)
    shared = (GATES_CHALLENGES * (num_pi + slots) + num_pi) * 8
    if shared > GEN_MAX_SHARED_BYTES:
        raise ValueError(f"{what}: {num_pi} public inputs and {slots} slots need {shared} bytes "
                         f"of shared memory")
    return {"n_lde": n_lde, "wires_stride": wires_lde.stride(0), "consts_stride": pre_lde.stride(0),
            "sel": {name: p[0] for name, p in params.items() if p}, "arith_ops": arith_ops,
            "bs_bits": bs_bits, "bs_slots": bs_slots, "const_slots": const_slots,
            "visit": max(4 * arith_ops, GEN_BS_STRIDE * bs_slots, const_slots), "slots": slots,
            "num_pi": num_pi, "lr_stride": lr.stride(0) if num_pi > 1 else n_lde,
            "shared_bytes": shared}


def generic_gate_quotient(gates: list, wires_lde, pre_lde, num_sel: int, num_constants: int, lr,
                          pi_f, pi_cols, apows: list, accs: list, pi0: int, k0: int) -> None:
    """Launch ``generic_gate_quotient_kernel``: accs[j] += sum_i
    apows[j][pi0 + i] lr_i (w_{c_i} - pi_i) + sum over the generic gates of
    sel * sum_k apows[j][k0 + k] C_k, in place (see ``generic_gate_plan``)."""
    for t, name in ((wires_lde, "wires_lde"), (pre_lde, "pre_lde"), (lr, "lr"), (pi_f, "pi_f"),
                    (pi_cols, "pi_cols"), *((a, f"alpha row {j}") for j, a in enumerate(apows)),
                    *((a, f"acc {j}") for j, a in enumerate(accs))):
        _check(t, name)
    plan = generic_gate_plan(gates, wires_lde, pre_lde, num_sel, num_constants, lr, pi_f, pi_cols,
                             apows, accs, pi0, k0)
    if not gates and not plan["num_pi"]:
        return  # nothing to add

    def sel(name):
        return pre_lde[plan["sel"][name]].data_ptr() if name in plan["sel"] else None

    err = _libraries()["gates"].elp_generic_gate_quotient(
        wires_lde.data_ptr(), plan["wires_stride"], pre_lde[num_sel].data_ptr(),
        plan["consts_stride"], sel("arith"), sel("basesum2"), sel("const"), plan["arith_ops"],
        plan["bs_bits"], plan["bs_slots"], plan["const_slots"], lr.data_ptr(), plan["lr_stride"],
        pi_f.data_ptr(), pi_cols.data_ptr(), plan["num_pi"], apows[0].data_ptr(),
        apows[1].data_ptr(), pi0, k0, accs[0].data_ptr(), accs[1].data_ptr(), plan["n_lde"],
        GATES_THREADS, _stream(wires_lde))
    launches["gates"] += 1
    _raise_on(err, "generic gates")
