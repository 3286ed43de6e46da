"""Fiat-Shamir transcript: Poseidon duplex challenger.

Port of ``eth_lc_plonky2_tpu/prover/transcript.py``, the role of plonky2's
`Challenger` in the prover (Fiat-Shamir -> beta, gamma; alpha; zeta):
absorbs commitments/openings, squeezes field challenges.  Host-side
scalar code (a transcript is a few dozen permutations); the duplex
rule is this framework's own fixed spec:

  * observe(x): push x to the input buffer; clear pending outputs
  * squeeze: while input pending (or no outputs), absorb chunks of 8
    by overwriting state[0..len(chunk)], permute, set outputs =
    state[0..8] consumed left-to-right.

Given an enabled ``Profiler``, each duplex is a ``transcript`` span and its
permutations are counted under ``transcript_permutations``; the prover's
device reads reach the same profiler through ``prof``.
"""

from __future__ import annotations

from ..ops import poseidon as pos
from ..ops import goldilocks as gl
from .profiler import Profiler

P = gl.P


class Challenger:
    def __init__(self, prof: Profiler | None = None):
        self.prof = prof if prof is not None else Profiler(enabled=False)
        self.state = [0] * pos.WIDTH
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    # -- observe ---------------------------------------------------------

    def observe(self, x: int):
        self.output_buffer.clear()
        self.input_buffer.append(int(x) % P)

    def observe_many(self, xs):
        for x in xs:
            self.observe(x)

    def observe_digest(self, digest4):
        self.observe_many(digest4)

    def observe_cap(self, cap):
        """cap: iterable of 4-element digests."""
        for d in cap:
            self.observe_digest(d)

    def observe_ext(self, x_ext):
        self.observe(x_ext[0])
        self.observe(x_ext[1])

    # -- squeeze ---------------------------------------------------------

    def _duplex(self):
        with self.prof.span("transcript"):
            n = len(self.input_buffer)
            if n:
                for start in range(0, n, pos.SPONGE_RATE):
                    chunk = self.input_buffer[start : start + pos.SPONGE_RATE]
                    self.state[: len(chunk)] = chunk
                    self.state = pos.permute_host(self.state)
                self.input_buffer.clear()
            else:
                self.state = pos.permute_host(self.state)
            self.output_buffer = list(self.state[: pos.SPONGE_RATE])
            # one permutation a chunk of the input, or one with no input
            self.prof.count("transcript_permutations", -(-n // pos.SPONGE_RATE) or 1)

    def challenge(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop(0)

    def challenges(self, n: int) -> list[int]:
        return [self.challenge() for _ in range(n)]

    def challenge_ext(self) -> tuple[int, int]:
        a = self.challenge()
        b = self.challenge()
        return (a, b)
