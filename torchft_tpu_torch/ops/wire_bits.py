"""The bit-exact special cases of the wire kernels.

``CAST_BF16_WORDS`` maps f32 bit patterns to the bf16 word the bf16 wire
cast (K3) gives each: NaNs of either sign and any payload become
``sign | 0x7FC0``, Inf stays Inf, the largest finite f32 rounds to Inf,
the two ties round to even, and subnormals and signed zeros keep their
sign. ``Q8_DECODE_SPECIALS`` holds special scales of the q8 decode (K2),
the codes of one leaf per scale, and the f32 bits the leaves decode to: a
NaN scale and an Inf scale on zero codes poison their leaf with
``0x7FC00000``, and the subnormal scale ``0x0001A2B3`` keeps the IEEE
products (ROADMAP F5). The tests and ``chip_smoke.py`` hold the kernels
and their plain versions to these tables.
"""

CAST_BF16_WORDS = {
    0x7FC00000: 0x7FC0, 0x7FFFFFFF: 0x7FC0, 0x7F800001: 0x7FC0,
    0xFFC00000: 0xFFC0, 0xFFFFFFFF: 0xFFC0, 0xFFC00001: 0xFFC0,
    0x7F800000: 0x7F80, 0xFF800000: 0xFF80, 0x7F7FFFFF: 0x7F80,
    0x3F808000: 0x3F80, 0x3F818000: 0x3F82, 0x00000001: 0x0000,
    0x0001A2B3: 0x0002, 0x80400000: 0x8040, 0x00000000: 0x0000,
    0x80000000: 0x8000,
}

# (scale bits, the codes of one leaf per scale, the decoded f32 bits)
Q8_DECODE_SPECIALS = (
    [0x7FC00000, 0x7F800000, 0x0001A2B3, 0x3E800000],
    [[1, -2], [0, 0], [1, -3, 127], [9]],
    [0x7FC00000] * 4 + [0x0001A2B3, 0x8004E819, 0x00CFB6CD, 0x40100000],
)
