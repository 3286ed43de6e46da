"""Witness generation, the mean a distinct witness of the cell (the inputs'
inner proofs where the circuit absorbs one, the setters and the generators), by
the host clock around those calls in the cell's set-up module, in s."""


def read(record: dict):
    return record["setup"].get("witness_gen_s")
