"""julia: z -> z^2 + c, z starting at the pixel's point, ``c`` the
configuration's constant (``params["c"]``, a pair) rounded to f32."""

import numpy as np
import torch

from bench.reference import escape

STEP_FLOPS = 8  # as mandelbrot's: the step differs only in its addend


def addend(cr, ci, params):
    c_re, c_im = (float(np.float32(v)) for v in params["c"])
    return torch.full_like(cr, c_re), torch.full_like(ci, c_im)


step = escape.quadratic_step


def coarse_addend(z, params):
    return np.full_like(z, complex(*params["c"]))


def coarse_step(z, k):
    return z * z + k
