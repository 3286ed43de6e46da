"""Witness staging a proof: the host's gather and transpose of the witness
matrix and its upload (the ``witness_matrix`` and ``witness_upload`` phases of
the program's ``Profiler`` record), the mean over the traced window's proofs,
in ms."""

PHASES = ("witness_matrix", "witness_upload")


def read(record: dict):
    profiles = record["profiles"]
    if not profiles:
        return None
    return 1e3 * sum(sum(p.get(k, 0.0) for k in PHASES) for p in profiles) / len(profiles)
