"""FRI and its transcript a proof: every phase of the ``Profiler`` record whose
name starts with ``fri`` (the combination's transcript work, G, the folds and
layer trees, the grind, the final polynomial, the queries), the mean over the
traced window's proofs, in ms."""


def read(record: dict):
    profiles = record["profiles"]
    if not profiles:
        return None
    return 1e3 * sum(sum(v for k, v in p.items() if k.startswith("fri")) for p in profiles) / len(
        profiles)
