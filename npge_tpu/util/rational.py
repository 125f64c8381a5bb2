"""Exact rational threshold arithmetic.

Equivalent of the reference's fixed-point ``Decimal``
(``src/util/Decimal.hpp`` ⚠[B], SURVEY.md §2.4): NPGe deliberately avoids
float nondeterminism in identity-threshold comparisons. We mirror that by
keeping thresholds as exact integer rationals and doing all comparisons in
integer arithmetic — key for bit-exact reruns and for N-host == 1-chip
determinism (SURVEY.md §7 hard part 4).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Rational:
    num: int
    den: int

    def __post_init__(self):
        if self.den <= 0:
            raise ValueError("denominator must be positive")

    @staticmethod
    def parse(text: str | float | int | "Rational") -> "Rational":
        """Parse '0.9', '9/10', 0.9, Rational — into an exact rational."""
        if isinstance(text, Rational):
            return text
        if isinstance(text, int):
            return Rational(text, 1)
        s = str(text)
        if "/" in s:
            a, b = s.split("/")
            return Rational(int(a), int(b))
        if "." in s:
            whole, frac = s.split(".")
            den = 10 ** len(frac)
            sign = -1 if whole.startswith("-") else 1
            whole_i = int(whole) if whole not in ("", "-") else 0
            return Rational(whole_i * den + sign * int(frac or 0), den)
        return Rational(int(s), 1)

    def __float__(self) -> float:
        return self.num / self.den

    def __str__(self) -> str:
        return f"{self.num}/{self.den}"

    # a/b >= c/d  <=>  a*d >= c*b   (b, d > 0)
    def le_ratio(self, num: int, den: int) -> bool:
        """self <= num/den, exactly (den > 0)."""
        return self.num * den <= num * self.den

    def ge_ratio(self, num: int, den: int) -> bool:
        """self >= num/den, exactly (den > 0)."""
        return self.num * den >= num * self.den

    def mul_ceil(self, x: int) -> int:
        """ceil(self * x) in exact integer arithmetic."""
        return -((-self.num * x) // self.den)

    def mul_floor(self, x: int) -> int:
        """floor(self * x) in exact integer arithmetic."""
        return (self.num * x) // self.den
