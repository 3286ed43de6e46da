"""Variants of csrc/sha256.cu for tools/field_variants.py:

    python3 tools/field_variants.py tools/variants/sha256_rounds.py --source sha256.cu

"rolled": the loops over rounds 16..63 and over the padding block's 64 rounds
stay rolled around one unrolled body of 16 rounds (the base unrolls all 64):
a third of the code for the instruction cache, against a rolled loop's
branches and its indexed loads of the constants."""

VARIANTS = {
    "rolled": [("constexpr int BODIES_UNROLLED = 4;", "constexpr int BODIES_UNROLLED = 1;")],
}
