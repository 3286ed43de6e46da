"""The wall time of a proof: the traced window's seconds over the proofs
completed in it, by the host's clock, in s.  The traced window marks the
program's phases, each ending in a synchronize, so it reads a little above an
untraced window."""


def read(record: dict):
    window = record.get("window")
    if not window or not window["proofs"]:
        return None
    return window["seconds"] / window["proofs"]
