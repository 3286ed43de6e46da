"""The benchmark's judge of a proof: a frozen copy of the repository's
standalone verifier (``tools/verify_standalone.py``), standard library only.

Everything is re-derived from the proof format's specification
(``docs/proof_format.md``): Goldilocks and GF(p^2) arithmetic, the Grain-LFSR
Poseidon permutation, the duplex Fiat-Shamir transcript, Merkle cap paths, the
constraint identity at zeta (gate constraints interpreted from the bundle's
expression DAGs) and the batched FRI low-degree proof.  It imports neither the
program nor its reference package, so a later change to either cannot move
what it accepts.

``verify_bundle(bundle)`` returns True or raises ``VerificationError``.
"""

import json
import sys

# ---------------------------------------------------------------------------
# Field: Goldilocks p = 2^64 - 2^32 + 1; extension GF(p^2) = GF(p)[X]/(X^2-7)
# ---------------------------------------------------------------------------

P = (1 << 64) - (1 << 32) + 1
W = 7  # phi^2 = 7
GENERATOR = 7  # multiplicative generator of GF(p)^*; also the LDE coset shift
TWO_ADICITY = 32


def inv(a):
    return pow(a, P - 2, P)


def root_of_unity(n_log):
    base = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)
    for _ in range(TWO_ADICITY - n_log):
        base = base * base % P
    return base


def e_add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def e_sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def e_mul(x, y):
    a, b = x
    c, d = y
    return ((a * c + W * b * d) % P, (a * d + b * c) % P)


def e_inv(x):
    a, b = x
    n = (a * a - W * b * b) % P
    ni = inv(n)
    return (a * ni % P, -b * ni % P)


def e_pow(x, e):
    acc = (1, 0)
    base = x
    while e:
        if e & 1:
            acc = e_mul(acc, base)
        base = e_mul(base, base)
        e >>= 1
    return acc


# ---------------------------------------------------------------------------
# Poseidon (width 12, 4+22+4 rounds, x^7 s-box, Grain LFSR round constants)
# ---------------------------------------------------------------------------

WIDTH = 12
N_FULL = 8
N_PARTIAL = 22
RATE = 8
MDS_CIRC = [17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20]
MDS_DIAG = [8] + [0] * 11


def _grain_bits():
    state = []

    def push(value, width):
        for i in range(width - 1, -1, -1):
            state.append((value >> i) & 1)

    push(0b01, 2)        # field = prime
    push(0b0000, 4)      # s-box = x^alpha
    push(64, 12)         # n
    push(WIDTH, 12)      # t
    push(N_FULL, 10)
    push(N_PARTIAL, 10)
    push((1 << 30) - 1, 30)
    assert len(state) == 80

    def clock():
        new = state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13] ^ state[0]
        state.pop(0)
        state.append(new)
        return new

    for _ in range(160):
        clock()
    while True:
        b1 = clock()
        b2 = clock()
        if b1 == 1:
            yield b2


def _round_constants():
    gen = _grain_bits()
    out = []
    while len(out) < (N_FULL + N_PARTIAL) * WIDTH:
        v = 0
        for _ in range(64):
            v = (v << 1) | next(gen)
        if v < P:
            out.append(v)
    return out


_RC = _round_constants()


def _mds(v):
    out = []
    for r in range(WIDTH):
        acc = 0
        for i in range(WIDTH):
            acc += MDS_CIRC[i] * v[(r + i) % WIDTH]
        acc += MDS_DIAG[r] * v[r]
        out.append(acc % P)
    return out


def permute(state):
    s = [x % P for x in state]
    half = N_FULL // 2
    r = 0
    for _ in range(half):
        s = [(x + _RC[r * WIDTH + i]) % P for i, x in enumerate(s)]
        s = [pow(x, 7, P) for x in s]
        s = _mds(s)
        r += 1
    for _ in range(N_PARTIAL):
        s = [(x + _RC[r * WIDTH + i]) % P for i, x in enumerate(s)]
        s[0] = pow(s[0], 7, P)
        s = _mds(s)
        r += 1
    for _ in range(half):
        s = [(x + _RC[r * WIDTH + i]) % P for i, x in enumerate(s)]
        s = [pow(x, 7, P) for x in s]
        s = _mds(s)
        r += 1
    return s


def hash_no_pad(inputs):
    state = [0] * WIDTH
    for start in range(0, len(inputs), RATE):
        chunk = inputs[start : start + RATE]
        state[: len(chunk)] = [x % P for x in chunk]
        state = permute(state)
    return state[:4]


def compress(left, right):
    state = list(left) + list(right) + [0] * (WIDTH - 8)
    return permute(state)[:4]


# ---------------------------------------------------------------------------
# Duplex transcript
# ---------------------------------------------------------------------------


class Challenger:
    def __init__(self):
        self.state = [0] * WIDTH
        self.inp = []
        self.out = []

    def observe(self, x):
        self.out.clear()
        self.inp.append(int(x) % P)

    def observe_many(self, xs):
        for x in xs:
            self.observe(x)

    def observe_cap(self, cap):
        for d in cap:
            self.observe_many(d)

    def _duplex(self):
        if self.inp:
            for start in range(0, len(self.inp), RATE):
                chunk = self.inp[start : start + RATE]
                self.state[: len(chunk)] = chunk
                self.state = permute(self.state)
            self.inp.clear()
        else:
            self.state = permute(self.state)
        self.out = list(self.state[:RATE])

    def challenge(self):
        if self.inp or not self.out:
            self._duplex()
        return self.out.pop(0)

    def challenge_ext(self):
        a = self.challenge()
        b = self.challenge()
        return (a, b)


# ---------------------------------------------------------------------------
# Merkle cap path check
# ---------------------------------------------------------------------------


def verify_merkle(leaf_values, index, path, cap):
    digest = hash_no_pad([int(v) for v in leaf_values])
    idx = index
    for sib in path:
        sib = [int(v) for v in sib]
        if idx & 1:
            digest = compress(sib, digest)
        else:
            digest = compress(digest, sib)
        idx >>= 1
    return digest == [int(v) for v in cap[idx]]


# ---------------------------------------------------------------------------
# Gate constraint DAG interpreter (over GF(p^2))
# ---------------------------------------------------------------------------


def eval_gate(expr, wires, ccol):
    vals = []
    for node in expr["nodes"]:
        kind = node[0]
        if kind == "const":
            vals.append((int(node[1]) % P, 0))
        elif kind == "wire":
            vals.append(wires(int(node[1]), int(node[2])))
        elif kind == "ccol":
            vals.append(ccol(int(node[1])))
        elif kind == "add":
            vals.append(e_add(vals[node[1]], vals[node[2]]))
        elif kind == "sub":
            vals.append(e_sub(vals[node[1]], vals[node[2]]))
        elif kind == "mul":
            vals.append(e_mul(vals[node[1]], vals[node[2]]))
        else:
            raise ValueError(f"unknown node kind {kind}")
    return [vals[i] for i in expr["outputs"]]


# ---------------------------------------------------------------------------
# The verifier
# ---------------------------------------------------------------------------


def _iv(h):  # hex string -> int
    return int(h, 16)


def _rows(rows):  # [[hex...]] -> [[int...]]
    return [[_iv(v) for v in row] for row in rows]


class VerificationError(Exception):
    pass


def _chk(cond, msg):
    if not cond:
        raise VerificationError(msg)


def verify_bundle(bundle):
    _chk(bundle["format"] == "eth-lc-plonky2-tpu/proof-bundle/v1", "bad format tag")
    cfg = bundle["config"]
    fri = cfg["fri"]
    circ = bundle["circuit"]
    proof = bundle["proof"]

    log_n = circ["log_n"]
    n = 1 << log_n
    rate = fri["rate_bits"]
    n_lde = n << rate
    m = cfg["num_routed_wires"] // cfg["permutation_chunk_size"]
    cs = cfg["permutation_chunk_size"]
    nch = cfg["num_challenges"]
    num_sel = len(circ["gate_names"])
    num_con = cfg["num_constants"]
    nr = cfg["num_routed_wires"]

    pre_cap = _rows(bundle["vk"]["pre_cap"])
    pis = [_iv(v) for v in proof["public_inputs"]]
    wires_cap = _rows(proof["wires_cap"])
    zs_cap = _rows(proof["zs_cap"])
    quotient_cap = _rows(proof["quotient_cap"])
    openings = {}
    for key, rows in proof["openings"].items():
        tag, off = key.split(":")
        openings[(tag, int(off))] = [(_iv(r[0]), _iv(r[1])) for r in rows]

    point_specs = [("P", 0)]
    for off in circ["wire_offsets"]:
        point_specs.append(("W", int(off)))
    point_specs += [("Z", 0), ("Z", 1), ("Q", 0)]

    counts = {
        "P": num_sel + num_con + nr,
        "W": cfg["num_wires"],
        "Z": nch * m,
        "Q": nch * (1 << rate),
    }
    for tag, off in point_specs:
        _chk(len(openings[(tag, off)]) == counts[tag], f"opening count {tag}:{off}")
    _chk(len(pis) == len(circ["public_input_rows"]), "public input count")

    # ---- 1. replay the transcript -------------------------------------
    ch = Challenger()
    ch.observe_cap(pre_cap)
    ch.observe_many(pis)
    ch.observe_cap(wires_cap)
    betas, gammas = [], []
    for _ in range(nch):
        betas.append(ch.challenge())
        gammas.append(ch.challenge())
    ch.observe_cap(zs_cap)
    alphas = [ch.challenge() for _ in range(nch)]
    ch.observe_cap(quotient_cap)
    zeta = ch.challenge_ext()
    for tag, off in point_specs:
        for re, im in openings[(tag, off)]:
            ch.observe(re)
            ch.observe(im)
    fri_alpha = ch.challenge_ext()

    # ---- 2. constraint identity at zeta -------------------------------
    omega = root_of_unity(log_n)
    p_open = openings[("P", 0)]
    z_open = openings[("Z", 0)]
    z_next_open = openings[("Z", 1)]
    q_open = openings[("Q", 0)]
    k_shifts = [pow(GENERATOR, c, P) for c in range(nr)]

    def wires(col, offset=0):
        return openings[("W", offset)][col]

    def ccol(i):
        return p_open[num_sel + i]

    def sigma_c(c):
        return p_open[num_sel + num_con + c]

    gates = circ["gates"]
    max_con = max((len(g["outputs"]) for g in gates), default=0)
    gate_slots = [(0, 0)] * max_con
    for gi, g in enumerate(gates):
        cons = eval_gate(g, wires, ccol)
        s = p_open[gi]  # selector opening
        for k, cval in enumerate(cons):
            gate_slots[k] = e_add(gate_slots[k], e_mul(s, cval))

    zeta_n = e_pow(zeta, n)
    zh = e_sub(zeta_n, (1, 0))
    _chk(zh != (0, 0), "zeta in H")
    n_inv = inv(n)
    l0 = e_mul(zh, e_mul(e_inv(e_sub(zeta, (1, 0))), (n_inv, 0)))

    pi_terms = []
    for (r, c), piv in zip(circ["public_input_rows"], pis):
        wr = pow(omega, r, P)
        lr = e_mul(zh, e_mul(e_inv(e_sub(zeta, (wr, 0))), (wr * n_inv % P, 0)))
        pi_terms.append(e_mul(lr, e_sub(wires(c), (piv % P, 0))))

    for j in range(nch):
        z_j = z_open[j * m]
        z_next = z_next_open[j * m]
        partials = [z_open[j * m + 1 + k] for k in range(m - 1)]
        chain = [z_j] + partials + [z_next]
        terms = [e_mul(l0, e_sub(z_j, (1, 0)))]
        for k in range(m):
            acc_n = (1, 0)
            acc_d = (1, 0)
            for c in range(k * cs, (k + 1) * cs):
                wv = wires(c)
                idv = e_mul((k_shifts[c], 0), zeta)
                nterm = e_add(e_add(wv, e_mul((betas[j], 0), idv)), (gammas[j], 0))
                dterm = e_add(e_add(wv, e_mul((betas[j], 0), sigma_c(c))), (gammas[j], 0))
                acc_n = e_mul(acc_n, nterm)
                acc_d = e_mul(acc_d, dterm)
            terms.append(e_sub(e_mul(chain[k + 1], acc_d), e_mul(chain[k], acc_n)))
        terms.extend(pi_terms)
        terms.extend(gate_slots)
        combined = (0, 0)
        for t in reversed(terms):
            combined = e_add(e_mul(combined, (alphas[j], 0)), t)
        tq = (0, 0)
        zpow = (1, 0)
        for k in range(1 << rate):
            tq = e_add(tq, e_mul(zpow, q_open[j * (1 << rate) + k]))
            zpow = e_mul(zpow, zeta_n)
        _chk(combined == e_mul(zh, tq), f"constraint identity (challenge {j})")

    # ---- 3. FRI --------------------------------------------------------
    fproof = proof["fri"]
    layer_caps = [_rows(c) for c in fproof["layer_caps"]]
    final_poly = [(_iv(r[0]), _iv(r[1])) for r in fproof["final_poly"]]
    pow_witness = _iv(fproof["pow_witness"])

    fri_betas = []
    for cap in layer_caps:
        ch.observe_cap(cap)
        fri_betas.append(ch.challenge_ext())
    for re, im in final_poly:
        ch.observe(re)
        ch.observe(im)
    pow_c = ch.challenge()
    digest = hash_no_pad([pow_c, pow_witness])
    _chk(digest[0] < (1 << (64 - fri["proof_of_work_bits"])), "proof of work")
    ch.observe(pow_witness)
    indices = [ch.challenge() % n_lde for _ in range(fri["num_query_rounds"])]

    stop_size = 1 << (fri["final_poly_bits"] + rate)
    num_layers = 0
    sz = n_lde
    while sz > stop_size:
        num_layers += 1
        sz //= 2
    _chk(len(layer_caps) == num_layers, "FRI layer count")
    _chk(len(final_poly) == (sz >> rate), "final poly length")

    tags = ["P", "W", "Z", "Q"]
    offsets_g = {}
    acc = 0
    for t in tags:
        offsets_g[t] = acc
        acc += counts[t]
    total_polys = acc
    apow = [(1, 0)]
    for _ in range(total_polys + len(point_specs)):
        apow.append(e_mul(apow[-1], fri_alpha))

    y_points = []
    for j, (tag, off) in enumerate(point_specs):
        z_pt = e_mul(zeta, (pow(omega, off % n, P), 0))
        y_j = (0, 0)
        for i, v in enumerate(openings[(tag, off)]):
            y_j = e_add(y_j, e_mul(apow[offsets_g[tag] + i], v))
        y_points.append((tag, z_pt, y_j, apow[total_polys + j]))

    w_lde = root_of_unity(log_n + rate)
    caps = {"P": pre_cap, "W": wires_cap, "Z": zs_cap, "Q": quotient_cap}
    inv2 = inv(2)
    qproofs = fproof["query_proofs"]
    _chk(len(qproofs) == fri["num_query_rounds"], "query proof count")

    for qi, idx in enumerate(indices):
        qp = qproofs[qi]
        leaves = {t: [_iv(v) for v in qp["batch_leaves"][t]] for t in tags}
        paths = {t: _rows(qp["batch_paths"][t]) for t in tags}
        for tag in tags:
            _chk(len(leaves[tag]) == counts[tag], f"leaf width {tag}")
            _chk(verify_merkle(leaves[tag], idx, paths[tag], caps[tag]),
                 f"batch merkle {tag} @ query {qi}")
        x = GENERATOR * pow(w_lde, idx, P) % P
        g_val = (0, 0)
        for tag, z_pt, y_j, beta_j in y_points:
            bsum = (0, 0)
            for i in range(counts[tag]):
                bsum = e_add(bsum, e_mul(apow[offsets_g[tag] + i], (leaves[tag][i], 0)))
            numer = e_sub(bsum, y_j)
            denom = e_sub((x, 0), z_pt)
            g_val = e_add(g_val, e_mul(beta_j, e_mul(numer, e_inv(denom))))

        cur = idx
        size = n_lde
        shift = GENERATOR
        expected = g_val
        w_cur = w_lde
        for l in range(num_layers):
            h = size // 2
            jpos = cur % h
            leaf = [_iv(v) for v in qp["layer_leaves"][l]]
            slot = 0 if cur < h else 1
            _chk((leaf[2 * slot], leaf[2 * slot + 1]) == expected,
                 f"FRI layer {l} value @ query {qi}")
            _chk(verify_merkle(leaf, jpos, _rows(qp["layer_paths"][l]), layer_caps[l]),
                 f"FRI layer {l} merkle @ query {qi}")
            e0 = (leaf[0], leaf[1])
            e1 = (leaf[2], leaf[3])
            x_j = shift * pow(w_cur, jpos, P) % P
            t1 = e_mul(e_add(e0, e1), (inv2, 0))
            t2 = e_mul(fri_betas[l], e_mul(e_sub(e0, e1), (inv2 * inv(x_j) % P, 0)))
            expected = e_add(t1, t2)
            cur = jpos
            size = h
            shift = shift * shift % P
            w_cur = w_cur * w_cur % P

        # final polynomial evaluated at the folded point
        x_fin = shift * pow(w_cur, cur, P) % P
        val = (0, 0)
        for coeff in reversed(final_poly):
            val = e_add(e_mul(val, (x_fin, 0)), coeff)
        _chk(val == expected, f"final poly value @ query {qi}")

    return True


def main(argv):
    if len(argv) != 2:
        print("usage: verifier.py BUNDLE.json", file=sys.stderr)
        return 2
    with open(argv[1]) as f:
        bundle = json.load(f)
    verify_bundle(bundle)
    print("VERIFIED")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
