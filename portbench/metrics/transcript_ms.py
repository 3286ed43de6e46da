"""The transcript a proof: the host seconds of the program's ``transcript``
span (``Challenger._duplex``, the host Poseidon permutations of Fiat-Shamir,
in every phase), ``_transcript`` in the ``Profiler`` record, the mean over the
traced window's proofs, in ms.  It is host work the card waits for: it moves
the wall of a proof (``prove_wall_s``), not the card's busy time.  None where
the record has no such span."""

KEY = "_transcript"


def read(record: dict):
    profiles = record["profiles"]
    if not profiles or any(KEY not in p for p in profiles):
        return None
    return 1e3 * sum(p[KEY] for p in profiles) / len(profiles)
