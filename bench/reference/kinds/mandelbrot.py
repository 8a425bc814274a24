"""mandelbrot: z -> z^2 + c, c the pixel's point (z starts at c)."""

from bench.reference import escape

STEP_FLOPS = 8  # zr*zr, zi*zi, their difference, + cr, 2*zr, the FMA (2)


def addend(cr, ci, params):
    return cr, ci


step = escape.quadratic_step


def coarse_addend(z, params):
    return z


def coarse_step(z, k):
    return z * z + k
