"""Variants of csrc/field.cu's permutation terms for tools/field_variants.py:

    python3 tools/field_variants.py tools/variants/perm_ring.py

"nocopy": the chunk stages arrive without their copies (the ring's barriers
complete at once; the words are stale, so they differ), which times the
arithmetic and the ring's bookkeeping alone; "noarith": the consumers skip
the chunks' products, which times the copies alone."""

VARIANTS = {
    "nocopy": [("  mbar_expect_tx(&full[s], (2 * np + (chain ? NC : 0)) * seg);\n",
                "  mbar_arrive(&full[s]);\n  return;\n")],
    "noarith": [("        for (int r = 0; r < PERM_PAIRS; ++r) {\n          if (r < np) {",
                 "        for (int r = 0; r < PERM_PAIRS; ++r) {\n          if (r < 0) {")],
}
