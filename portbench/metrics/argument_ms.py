"""The permutation argument, the quotient and the openings a proof (the
``perm_polys``, ``quotient`` and ``openings`` phases of the ``Profiler``
record), the mean over the traced window's proofs, in ms."""

PHASES = ("perm_polys", "quotient", "openings")


def read(record: dict):
    profiles = record["profiles"]
    if not profiles:
        return None
    return 1e3 * sum(sum(p.get(k, 0.0) for k in PHASES) for p in profiles) / len(profiles)
