#!/usr/bin/env python3
"""How fast does one GPU run the integer instructions the port's kernels are made of?

    python3 tools/cuda_instruction_microbench.py

Both kernels of the port are long runs of 32-bit integer instructions:
``IMAD.WIDE`` (32 x 32 + 64 multiply-adds) and ``IADD3`` with carries.  This
script generates small CUDA kernels that are nothing but such instructions,
builds them with ``nvcc`` for ``sm_90a`` and reads, with ``clock64()``, how
many cycles a scheduler (SM sub-partition) needs per warp instruction:

  * by kind: wide products, wide multiply-adds, 32-bit multiply-adds, 32-bit
    adds, 64-bit adds with carry, and two alternating mixes.  If a mix needs
    about as many cycles a statement as its kinds alone, they share a pipe; if
    about half, they do not;
  * by size of the loop body: the same statements as a loop of 128 or of
    2,048 (2 KB or 32 KB of code and more).  If the long body is slower,
    instruction fetch limits straight-line code of that size;
  * by warps a scheduler: 1, 2, 4, 8.

Every chain feeds on the other chains' results and on the thread index, so
nothing folds away or moves to the uniform datapath; each thread stores a sum
of its registers at the end.  ptxas is free to split or regroup a statement,
so the script also prints what the 128-statement body became (opcode counts
from ``cuobjdump -sass``).  The card's name and power limit come first.
"""

from __future__ import annotations

import collections
import ctypes
import os
import subprocess
import sys
import tempfile

CHAINS = 8


STATEMENTS = {
    # 32 x 32 -> 64 product, no addend; both halves of every result are used later
    "mulwide": 'asm volatile("mul.wide.u32 %0, %1, %2;" : "=l"(acc[{k}]) : "r"((unsigned)acc[{n}]), "r"((unsigned)(acc[{m}] >> 32)));',
    # 32 x 32 + 64 multiply-add
    "madwide": 'asm volatile("mad.wide.u32 %0, %1, %2, %0;" : "+l"(acc[{k}]) : "r"((unsigned)acc[{n}]), "r"((unsigned)(acc[{m}] >> 32)));',
    # 32 x 32 + 32 multiply-add
    "mad32": 'asm volatile("mad.lo.u32 %0, %1, %2, %0;" : "+r"(x[{k}]) : "r"(x[{n}]), "r"(x[{m}]));',
    # 32-bit add
    "add32": 'asm volatile("add.u32 %0, %0, %1;" : "+r"(x[{k}]) : "r"(x[{n}]));',
    # 64-bit add as a carry chain
    "add64": 'asm volatile("add.cc.u32 %0, %0, %2; addc.u32 %1, %1, %3;" : "+r"(x[{k}]), "+r"(y[{k}]) : "r"(x[{n}]), "r"(y[{n}]));',
    # funnel shift and a three-input logic operation
    "shift": 'asm volatile("shf.l.wrap.b32 %0, %1, %2, 7;" : "=r"(x[{k}]) : "r"(x[{n}]), "r"(x[{m}]));',
    "logic": 'asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;" : "+r"(x[{k}]) : "r"(x[{n}]), "r"(x[{m}]));',
}
KINDS = {"mulwide": ("mulwide",), "madwide": ("madwide",), "mad32": ("mad32",),
         "add32": ("add32",), "add64": ("add64",), "shift": ("shift",), "logic": ("logic",),
         "madwide+add64": ("madwide", "add64"), "madwide+3 add64": ("madwide",) + ("add64",) * 3,
         "mad32+add32": ("mad32", "add32")}


def body(kind: str, count: int) -> str:
    """``count`` asm statements over CHAINS chains, the kinds of ``kind`` in turns."""
    kinds = KINDS[kind]
    return "\n    ".join(STATEMENTS[kinds[i % len(kinds)]].format(k=i % CHAINS, n=(i + 3) % CHAINS,
                                                                   m=(i + 5) % CHAINS)
                         for i in range(count))


def source(cases) -> str:
    parts = ["#include <cstdint>\n#include <cuda_runtime.h>\n"]
    for name, kind, count in cases:
        parts.append(f"""
__global__ void {name}(int iters, unsigned seed, unsigned long long* out, long long* cycles) {{
  unsigned long long acc[{CHAINS}];
  unsigned x[{CHAINS}], y[{CHAINS}];
  for (int k = 0; k < {CHAINS}; ++k) {{
    acc[k] = seed + threadIdx.x * 7 + k;
    x[k] = seed * 3 + k + threadIdx.x * 5;
    y[k] = seed * 5 + k + threadIdx.x * 3;
  }}
  const long long t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {{
    {body(kind, count)}
  }}
  const long long t1 = clock64();
  unsigned long long sum = 0;
  for (int k = 0; k < {CHAINS}; ++k) sum += acc[k] + x[k] + y[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}}
extern "C" int run_{name}(int blocks, int threads, int iters, void* out, void* cycles) {{
  {name}<<<blocks, threads>>>(iters, 12345u, (unsigned long long*)out, (long long*)cycles);
  return (int)cudaGetLastError();
}}
""")
    return "".join(parts)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("this measurement needs an NVIDIA GPU")
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(res.stdout.strip(), flush=True)
    cases = [(f"k{i}_{count}", kind, count)
             for i, kind in enumerate(KINDS) for count in (128, 2048)]
    nvcc = "/usr/local/cuda/bin/nvcc"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "bench.cu"), os.path.join(tmp, "bench.so")
        with open(cu, "w") as f:
            f.write(source(cases))
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-o", so, cu], check=True)
        # what ptxas made of each kernel (the 128-statement body and a few dozen
        # instructions around it): opcode counts
        sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", so],
                              capture_output=True, text=True, check=True).stdout
        made = {}
        for chunk in sass.split("Function : ")[1:]:
            ops = [ln.split("*/")[1].split(";")[0].split() for ln in chunk.splitlines()
                   if ln.strip().startswith("/*0") and ";" in ln]
            ops = [op[1] if op[0].startswith("@") else op[0] for op in ops if op]
            hist = collections.Counter(".".join(part for part in op.split(".")
                                                if part in ("IMAD", "IADD3", "WIDE", "X", "IADD", "HI",
                                                            "VIADD", "MOV", "SHF", "LOP3"))
                                       or op.split(".")[0] for op in ops)
            made[chunk.splitlines()[0].strip()] = (len(ops), dict(hist.most_common(6)))
        lib = ctypes.CDLL(so)
        total = 1 << 20  # instructions a warp
        for name, kind, count in cases:
            fn = getattr(lib, f"run_{name}")
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            for warps in (1, 4, 8):  # warps a scheduler; 4 schedulers an SM, one block an SM
                threads = 32 * 4 * warps
                out = torch.empty(sms * threads, dtype=torch.int64, device="cuda")
                cycles = torch.zeros(sms, dtype=torch.int64, device="cuda")
                iters = total // count
                for _ in range(2):
                    err = fn(sms, threads, iters, out.data_ptr(), cycles.data_ptr())
                    if err != 0:
                        raise RuntimeError(f"{name}: launch failed, cudaError {err}")
                    torch.cuda.synchronize()
                per_instr = cycles.float().median().item() / (iters * count * warps)
                print(f"{kind:>14} body {count:>4} statements, {warps} warps a scheduler: "
                      f"{per_instr:.3f} cycles a statement a scheduler", flush=True)
            if count == 128:
                sass_name = next(k for k in made if name in k)
                print(f"{kind:>14}: the kernel with 128 statements has {made[sass_name][0]} "
                      f"instructions: {made[sass_name][1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
