"""The PTX carry chains of ``csrc/goldilocks.cuh``, run instruction by
instruction on Python integers.

The CUDA kernels carry LAZY words (any 64-bit representative) between steps,
and their reductions are inline PTX whose comments claim that no second carry
or borrow can occur.  No compiler for the card runs on the CPU, so this file
reads the ``asm`` statements out of the header itself and interprets them
with 32-bit (and 64-bit) wraparound and one carry flag.  A chain is right when
its result is congruent mod p to what it was given and no instruction that
does not write the flag lost a carry or a borrow.  The C++ between two ``asm``
statements (a call, a product) is written out again here.

The last test runs the sponge kernel's whole permutation on these chains and
holds it against the plain ``permute``.
"""

import itertools
import re

import numpy as np
import pytest

from eth_lc_plonky2_tpu_torch.ops import goldilocks as gl
from eth_lc_plonky2_tpu_torch.ops import kernels, poseidon as pos

P = gl.P
M64 = (1 << 64) - 1
EPSILON = (1 << 32) - 1

# Words at which a carry or a borrow is nearest: the ends of the range, the
# modulus and its neighbours, 2^64 mod p and its neighbours, words with one
# half all ones or all zeros.
EDGE = sorted({0, 1, 2, EPSILON - 1, EPSILON, EPSILON + 1, 1 << 33, (1 << 63) - 1, 1 << 63,
               P - 2, P - 1, P, P + 1, M64 - EPSILON, M64 - EPSILON + 1, M64 - (1 << 33) + 1,
               M64 - 1, M64, EPSILON << 32, (EPSILON << 32) - 1, (1 << 32) | 1})


# ---------------------------------------------------------------------------
# The header's asm statements
# ---------------------------------------------------------------------------


def _sections(block: str) -> list:
    """Split the inside of asm(...) at the colons that are not in a string."""
    parts, cur, in_str, prev = [], [], False, ""
    for ch in block:
        if ch == '"' and prev != "\\":
            in_str = not in_str
        if ch == ":" and not in_str:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        prev = ch
    return parts + ["".join(cur)]


def _asm_blocks() -> dict:
    """{function name: [(instructions, outputs, inputs), ...]} for every asm
    statement of goldilocks.cuh, in the order of the source.  An operand is
    (constraint, C name); instruction operands stay text."""
    text = (kernels.CSRC / "goldilocks.cuh").read_text()
    blocks = {}
    for match in re.finditer(r"\basm\((.*?)\);\n", text, re.DOTALL):
        head = text[: match.start()]
        name = re.findall(r"(\w+)\([^()]*\)\s*(?:const\s*)?\{", head)[-1]
        template, outputs, inputs = (_sections(match.group(1)) + ["", ""])[:3]
        code = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', template))
        code = code.replace("\\n", "\n").replace("\\t", " ")
        instructions = []
        for line in re.split(r"[;\n]", code):
            line = line.strip()
            if line in ("", "{", "}") or line.startswith(".reg"):
                continue
            op, _, rest = line.partition(" ")
            instructions.append((op, [a.strip() for a in re.findall(r"\s*(\{[^}]*\}|[^,]+)", rest)]))
        operands = [re.findall(r'"([=+&]*[lr])"\(([^()]+)\)', sec) for sec in (outputs, inputs)]
        blocks.setdefault(name, []).append((instructions, *operands))
    return blocks


BLOCKS = _asm_blocks()


def run_asm(name: str, which: int = 0, **values) -> dict:
    """Interpret one asm statement of function ``name``; ``values`` are its
    input operands (and the old values of "+" operands) by their C name.
    Returns the output operands by C name."""
    instructions, outputs, inputs = BLOCKS[name][which]
    regs = {f"%{k}": values[c_name] for k, (kind, c_name) in enumerate(outputs + inputs)
            if k >= len(outputs) or "+" in kind}
    for k, (kind, c_name) in enumerate(outputs + inputs):
        if f"%{k}" in regs:
            assert 0 <= regs[f"%{k}"] < (1 << (64 if kind[-1] == "l" else 32)), c_name
    flag = 0

    def val(arg):
        return regs[arg] if arg in regs else int(arg, 0)

    for op, args in instructions:
        parts = op.split(".")
        bits = 64 if parts[-1] in ("u64", "b64") else 32
        mask = (1 << bits) - 1
        writes_flag = "cc" in parts
        if parts[0] == "mov":  # mov.b64 {lo, hi}, x  or  mov.b64 x, {lo, hi}
            if args[0].startswith("{"):
                lo, hi = (a.strip() for a in args[0][1:-1].split(","))
                regs[lo], regs[hi] = val(args[1]) & 0xFFFFFFFF, val(args[1]) >> 32
            else:
                lo, hi = (val(a.strip()) for a in args[1][1:-1].split(","))
                regs[args[0]] = lo | (hi << 32)
            continue
        if parts[0] == "neg":
            regs[args[0]] = -val(args[1]) & mask
            continue
        a, b = val(args[1]), val(args[2])
        carry_in = flag if parts[0] in ("addc", "subc", "madc") else 0
        if parts[0] in ("add", "addc"):
            full = a + b + carry_in
        elif parts[0] in ("sub", "subc"):
            full = a - b - carry_in
        elif parts[0] in ("mad", "madc"):
            product = a * b
            full = ((product >> bits) if parts[1] == "hi" else (product & mask)) + val(args[3]) + carry_in
        else:
            raise NotImplementedError(op)
        out_flag = int(full < 0 or full > mask)
        # "subc m, 0, 0" turns a borrow into an all-ones mask; nothing else may wrap unseen
        mask_idiom = parts[0] == "subc" and args[1] == args[2] == "0"
        assert writes_flag or not out_flag or mask_idiom, f"{name}: `{op} {', '.join(args)}` lost a carry"
        if writes_flag:
            flag = out_flag
        regs[args[0]] = full & mask
    return {c_name: regs[f"%{k}"] for k, (_, c_name) in enumerate(outputs)}


# ---------------------------------------------------------------------------
# goldilocks.cuh, function by function
# ---------------------------------------------------------------------------


def reduce128_lazy(lo, hi):
    return run_asm("reduce128_lazy", lo=lo, hi=hi)["s"]


def reduce_halves_lazy(al, ah):
    return run_asm("reduce_halves_lazy", al=al, ah=ah)["s"]


def mul_lazy(a, b):
    return reduce128_lazy(a * b & M64, a * b >> 64)


def mul_add_lazy(a, b, c):
    out = run_asm("mul_add_lazy", a=a, b=b, c=c)
    return reduce128_lazy(out["lo"], out["hi"])


def add_lazy(a, b_canonical):
    assert b_canonical < P
    return run_asm("add_lazy", a=a, b_canonical=b_canonical)["s"]


class Acc:
    COLUMNS = ("x0", "x1", "x2", "y0", "y1", "y2", "z0", "z1", "z2")

    def __init__(self):
        self.cols = dict.fromkeys(self.COLUMNS, 0)

    def mac(self, a, b):
        out = run_asm("mac", a0=a & 0xFFFFFFFF, a1=a >> 32, b0=b & 0xFFFFFFFF, b1=b >> 32, **self.cols)
        self.cols = {c: out[c] for c in self.COLUMNS}

    def reduce_lazy(self):
        out = run_asm("reduce_lazy", 0, **self.cols)
        r = reduce128_lazy(out["lo"], out["hi"])
        return run_asm("reduce_lazy", 1, r=r, c=out["c"])["d"]


def sbox(x):
    x2 = mul_lazy(x, x)
    x3 = mul_lazy(x2, x)
    return mul_lazy(mul_lazy(x3, x3), x)


def _seeded(count, seed, below=1 << 64):
    return [int(v) % below for v in np.random.default_rng(seed).integers(0, 1 << 64, size=count,
                                                                         dtype=np.uint64)]


def test_every_chain_of_the_header_is_modelled():
    assert sorted(BLOCKS) == ["add_lazy", "mac", "mul_add_lazy", "reduce128_lazy",
                              "reduce_halves_lazy", "reduce_lazy"]
    assert [len(BLOCKS[k]) for k in sorted(BLOCKS)] == [1, 1, 1, 1, 1, 2]
    constants = (kernels.CSRC / "goldilocks.cuh").read_text()
    assert f"P = 0x{P:X}ull" in constants and f"EPSILON = 0x{EPSILON:X}ull" in constants


@pytest.mark.parametrize("words", ["edge", "seeded"])
def test_reduce128_lazy(words):
    pairs = (list(itertools.product(EDGE, EDGE)) if words == "edge"
             else list(zip(_seeded(4000, 1), _seeded(4000, 2))))
    for lo, hi in pairs:
        s = reduce128_lazy(lo, hi)
        assert 0 <= s <= M64 and s % P == ((hi << 64) | lo) % P, (hex(lo), hex(hi))


@pytest.mark.parametrize("words", ["edge", "seeded"])
def test_reduce_halves_lazy(words):
    top = (1 << 44) - 1
    small = [0, 1, EPSILON, EPSILON + 1, top - 1, top, EPSILON << 12, (1 << 32) * 4095 + EPSILON]
    pairs = (list(itertools.product(small, small)) if words == "edge"
             else list(zip(_seeded(4000, 3, 1 << 44), _seeded(4000, 4, 1 << 44))))
    for al, ah in pairs:
        s = reduce_halves_lazy(al, ah)
        assert 0 <= s <= M64 and s % P == (al + (ah << 32)) % P, (hex(al), hex(ah))


@pytest.mark.parametrize("words", ["edge", "seeded"])
def test_add_lazy(words):
    pairs = (list(itertools.product(EDGE, [b for b in EDGE if b < P])) if words == "edge"
             else list(zip(_seeded(4000, 5), _seeded(4000, 6, P))))
    for a, b in pairs:
        s = add_lazy(a, b)
        assert 0 <= s <= M64 and s % P == (a + b) % P, (hex(a), hex(b))


@pytest.mark.parametrize("words", ["edge", "seeded"])
def test_mul_lazy_and_mul_add_lazy(words):
    triples = (list(itertools.product(EDGE, EDGE, [0, 1, EPSILON, P - 1, P, M64])) if words == "edge"
               else list(zip(_seeded(3000, 7), _seeded(3000, 8), _seeded(3000, 9))))
    for a, b, c in triples:
        assert mul_lazy(a, b) % P == a * b % P, (hex(a), hex(b))
        assert mul_add_lazy(a, b, c) % P == (a * b + c) % P, (hex(a), hex(b), hex(c))


@pytest.mark.parametrize("x", EDGE, ids=hex)
def test_sbox_on_a_lazy_word(x):
    assert sbox(x) % P == pow(x, 7, P)
    rc = P - 1
    assert sbox(add_lazy(x, rc)) % P == pow(x + rc, 7, P)


@pytest.mark.parametrize("terms", [1, 11, 12, 256])
def test_acc_sums_products_of_lazy_words(terms):
    """The three 96-bit column sums: the largest products 2^8 times over (the
    most the header allows), edge words in turn, and seeded words."""
    cases = [[(M64, M64)] * terms,
             [(EDGE[(3 * i) % len(EDGE)], EDGE[-1 - (5 * i) % len(EDGE)]) for i in range(terms)],
             list(zip(_seeded(terms, 10 + terms), _seeded(terms, 20 + terms)))]
    for pairs in cases:
        acc = Acc()
        for a, b in pairs:
            acc.mac(a, b)
        d = acc.reduce_lazy()
        assert 0 <= d <= M64 and d % P == sum(a * b for a, b in pairs) % P


# ---------------------------------------------------------------------------
# csrc/poseidon.cu on these chains
# ---------------------------------------------------------------------------


def _kernel_tables():
    """The kernel's constant image, unpacked as its struct declares it."""
    image = pos.kernel_constants()
    words = [int(w) for w in np.frombuffer(image[:-56], dtype=np.uint64)]
    take = iter(words)
    table = lambda *shape: np.array([next(take) for _ in range(int(np.prod(shape)))],  # noqa: E731
                                    dtype=object).reshape(shape).tolist()
    tables = dict(rc_full=table(8, 12), first=table(12), init=table(11, 11), scalar=table(22),
                  row=table(22, 12), col=table(22, 11))
    tail = np.frombuffer(image[-56:], dtype=np.int32).tolist()
    tables.update(mds_sum=tail[:6], mds_diff=tail[6:12], mds_diag0=tail[12])
    assert next(take, None) is None
    return tables


def _mds(s, c):
    """``mds`` of poseidon.cu: two length-6 correlations on 16-bit limbs."""
    out = [0] * 12
    limbs = [[(x >> (16 * l)) & 0xFFFF for l in range(4)] for x in s]
    for r in range(6):
        y = [[0] * 4, [0] * 4]
        for l in range(4):
            p = sum(c["mds_sum"][i] * (limbs[(r + i) % 6][l] + limbs[(r + i) % 6 + 6][l])
                    for i in range(6))
            q = sum((1 if r + i < 6 else -1) * c["mds_diff"][i]
                    * (limbs[(r + i) % 6][l] - limbs[(r + i) % 6 + 6][l]) for i in range(6))
            assert abs(p) < 2**31 and abs(q) < 2**31
            y[0][l] = ((p + q) >> 1) + (c["mds_diag0"] * limbs[0][l] if r == 0 else 0)
            y[1][l] = (p - q) >> 1
            assert 0 <= y[0][l] < 2**27 and 0 <= y[1][l] < 2**27
        for k in range(2):
            out[r + 6 * k] = reduce_halves_lazy(y[k][0] + (y[k][1] << 16), y[k][2] + (y[k][3] << 16))
    return out


def _kernel_permute(s, c):
    """``permute`` of poseidon.cu: lazy words from the first to the last step."""
    s = list(s)
    for r in range(8):
        s = _mds([sbox(add_lazy(x, k)) for x, k in zip(s, c["rc_full"][r])], c)
        if r != 3:
            continue
        s = [add_lazy(x, k) for x, k in zip(s, c["first"])]
        t = []
        for i in range(11):
            acc = Acc()
            for j in range(11):
                acc.mac(c["init"][i][j], s[j + 1])
            t.append(acc.reduce_lazy())
        s[1:] = t
        for p in range(22):
            s0 = add_lazy(sbox(s[0]), c["scalar"][p])
            acc = Acc()
            acc.mac(c["row"][p][0], s0)
            for i in range(1, 12):
                acc.mac(c["row"][p][i], s[i])
            s[1:] = [mul_add_lazy(c["col"][p][i - 1], s0, s[i]) for i in range(1, 12)]
            s[0] = acc.reduce_lazy()
    return s


def _states():
    rng = np.random.default_rng(31)
    rows = [[0] * 12, [1] * 12, [P - 1] * 12, [EPSILON] * 12, [0, 1, P - 1, EPSILON] * 3]
    rows += rng.integers(0, P, size=(3, 12), dtype=np.uint64).tolist()
    return [[int(x) for x in row] for row in rows]


@pytest.mark.parametrize("case", range(8))
def test_kernel_permutation_on_the_chains_matches_permute(case):
    state = _states()[case]
    got = [x % P for x in _kernel_permute(state, _kernel_tables())]
    want = gl.to_u64(pos.permute(gl.from_u64(np.array([state], dtype=np.uint64))))[0]
    assert got == [int(x) for x in want]
