"""Variants of csrc/gates.cu's generic gates for tools/field_variants.py:

    python3 tools/field_variants.py tools/variants/generic_ring.py --source gates.cu

"nocopy": the wire stages arrive without their copies (stale words, so they
differ), which times the visits and the ring's bookkeeping alone; "noarith":
no wire is visited, which times the copies, the public inputs and the
epilogue."""

VARIANTS = {
    "nocopy": [("  mbar_expect_tx(&full[s], nr * seg);\n  if (st < wire_stages && nr == GEN_STAGE_ROWS) {",
                "  mbar_arrive(&full[s]);\n  return;\n  if (st < wire_stages && nr == GEN_STAGE_ROWS) {")],
    "noarith": [("              if (w0 + q0 + q < g.visit) visit(w0 + q0 + q, row[(q0 + q) * T]);",
                 "              if (w0 + q0 + q < 0) visit(w0 + q0 + q, row[(q0 + q) * T]);")],
}
