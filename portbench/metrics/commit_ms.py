"""The three commitments a proof (wires, Z and partial products, quotient:
IFFT, coset LDE, leaf sponge and Merkle levels), from the ``Profiler`` record,
the mean over the traced window's proofs, in ms."""

PHASES = ("commit_wires", "commit_zs", "commit_quotient")


def read(record: dict):
    profiles = record["profiles"]
    if not profiles:
        return None
    return 1e3 * sum(sum(p.get(k, 0.0) for k in PHASES) for p in profiles) / len(profiles)
