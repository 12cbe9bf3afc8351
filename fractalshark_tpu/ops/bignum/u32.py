"""32-bit-only integer primitives.

The NTT arithmetic is written without 64-bit integer multiplies; the
reference's GPU bignum leans on 64-bit Montgomery arithmetic
(``HpSharkFloatLib/MontgomeryCoreConstexpr.h``). Here every 64-bit
quantity is an explicit (hi, lo) pair of uint32, and the 32×32→64
product is composed from 16-bit halves — exact under uint32 wraparound
semantics.

All functions are elementwise over arrays and safe inside jit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

U16_MASK = np.uint32(0xFFFF)
U32_ONE = np.uint32(1)


def u32(x):
    return jnp.asarray(x, jnp.uint32)


def mul_full(a, b):
    """Full 64-bit product of uint32 a, b as (hi, lo) uint32 pair."""
    a0 = a & U16_MASK
    a1 = a >> 16
    b0 = b & U16_MASK
    b1 = b >> 16
    t = a0 * b0                       # <= (2^16-1)^2 < 2^32 exact
    u = a1 * b0 + (t >> 16)           # < 2^32 exact
    v = a0 * b1 + (u & U16_MASK)      # < 2^32 exact
    hi = a1 * b1 + (u >> 16) + (v >> 16)
    lo = (v << 16) | (t & U16_MASK)
    return hi, lo


def mul_lo(a, b):
    """Low 32 bits of the product (native wraparound)."""
    return a * b


def mul_hi(a, b):
    return mul_full(a, b)[0]


def add_carry(a, b):
    """(sum, carry) of uint32 addition."""
    s = a + b
    return s, (s < a).astype(jnp.uint32)


def add3_carry(a, b, c):
    """a + b + c (c in {0,1}): (sum, carry)."""
    s1, c1 = add_carry(a, b)
    s2 = s1 + c
    c2 = (s2 < s1).astype(jnp.uint32)
    return s2, c1 + c2


def sub_borrow(a, b):
    """(difference, borrow) of uint32 subtraction."""
    d = a - b
    return d, (a < b).astype(jnp.uint32)


def add64(ahi, alo, bhi, blo):
    """(hi, lo) + (hi, lo) mod 2^64."""
    lo, c = add_carry(alo, blo)
    hi = ahi + bhi + c
    return hi, lo
