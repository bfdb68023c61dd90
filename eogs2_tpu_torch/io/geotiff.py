"""GeoTIFF georeferencing: the row-major 2D ``Affine`` transform.

Reading and writing rasters arrive with the artifact writers; the DSM path
needs only the transform.
"""

from __future__ import annotations


class Affine:
    """Row-major 2D affine (a, b, c, d, e, f): x = a*col + b*row + c."""

    def __init__(self, a, b, c, d, e, f):
        self.a, self.b, self.c, self.d, self.e, self.f = a, b, c, d, e, f

    @classmethod
    def from_origin(cls, xoff, yoff, xres, yres):
        return cls(xres, 0.0, xoff, 0.0, -yres, yoff)

    def __mul__(self, colrow):
        col, row = colrow
        return (
            self.a * col + self.b * row + self.c,
            self.d * col + self.e * row + self.f,
        )

    def inv(self, xy):
        x, y = xy
        det = self.a * self.e - self.b * self.d
        x -= self.c
        y -= self.f
        return (
            (self.e * x - self.b * y) / det,
            (-self.d * x + self.a * y) / det,
        )

    def __repr__(self):
        return f"Affine({self.a}, {self.b}, {self.c}, {self.d}, {self.e}, {self.f})"
