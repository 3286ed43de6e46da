"""The host's time blocked on the card a proof: the program's ``device_read``
span (each blocking read of device data: the commitments' and FRI layers'
caps, the openings, the final polynomial, the grind's test of each batch, the
query rows and paths) and the phase marks' synchronize (``_sync_wait``), from
the ``Profiler`` record, the mean over the traced window's proofs, in ms.  It
falls with the card's busy time.  None where the record has no
``_device_read``."""

KEY = "_device_read"


def read(record: dict):
    profiles = record["profiles"]
    if not profiles or any(KEY not in p for p in profiles):
        return None
    return 1e3 * sum(p[KEY] + p.get("_sync_wait", 0.0) for p in profiles) / len(profiles)
