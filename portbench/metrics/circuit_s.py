"""The circuit's set-up: building it (or loading it from the circuit cache) and
its preprocess, with any inner circuit it pins, by the host clock around those
calls in the cell's set-up module, in s."""


def read(record: dict):
    return record["setup"].get("circuit_s")
