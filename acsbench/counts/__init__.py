"""The operations and bytes of the work a step needs, from shapes: one
module a kernel or stage, found by name (``harness.counts(name)``). Each
counts every input byte read once and every output byte written once, and
only the products the result needs, so no share of a peak built on them
can pass 100 % of the time it divides."""
