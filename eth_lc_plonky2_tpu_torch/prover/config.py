"""Circuit / FRI configuration.

Copy of ``eth_lc_plonky2_tpu/prover/config.py`` (the port keeps its own).
The shape follows plonky2's `CircuitConfig::standard_recursion_config()`:
80 routed wires, rate_bits=3, cap_height=4, pow_bits=16, 28 query rounds,
2 challenge repetitions, degree-2 extension for the opening point.

The numbers here are this framework's own defaults, chosen for the
same ~100-bit conjectured security point: 28 queries at rate 1/8
(3 bits/query) + 16 PoW bits, duplicated base-field challenges for
the permutation/quotient batching.

Note: like the reference's standard config, proofs are NOT
zero-knowledge (no blinding) — the circuit proves public statements.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FriConfig:
    rate_bits: int = 3
    cap_height: int = 4
    proof_of_work_bits: int = 16
    num_query_rounds: int = 28
    # radix-2 folding; stop when the layer has <= 2^final_poly_bits coeffs
    final_poly_bits: int = 5


@dataclasses.dataclass(frozen=True)
class CircuitConfig:
    num_wires: int = 96
    num_routed_wires: int = 80
    num_constants: int = 6
    num_challenges: int = 2  # repetitions of (beta, gamma, alpha)
    permutation_chunk_size: int = 8
    fri: FriConfig = dataclasses.field(default_factory=FriConfig)

    @property
    def num_permutation_chunks(self) -> int:
        assert self.num_routed_wires % self.permutation_chunk_size == 0
        return self.num_routed_wires // self.permutation_chunk_size

    @property
    def num_partial_products(self) -> int:
        # partials p_0..p_{m-2}; the chain closes on Z(omega x)
        return self.num_permutation_chunks - 1

    @property
    def rate_bits(self) -> int:
        return self.fri.rate_bits

    @property
    def cap_height(self) -> int:
        return self.fri.cap_height
