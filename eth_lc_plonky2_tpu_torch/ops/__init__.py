"""Field, extension field, NTT and Poseidon ops, and the kernel launchers."""
