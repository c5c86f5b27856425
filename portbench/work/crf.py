"""Operations of the dense CRF at a configuration's parameters, for a
batch of (h, w) images with L labels (a copy of the count in the port's
``tools/profile_crf.py``, ``analytic``, with the geometry worked out here).

The operations are those of the sparse forms of the cell-plane mean
field: 8 lattice corners a (pixel, label) for each splat and slice, the
color band stencil on every lattice value, 2 x taps a blurred value and
the normalization multiply for the spatial Gaussian, 20 operations a
(pixel, label) for the step's messages, unary and softmax, and the dense
cross-cell blur.  The region's bytes are its inputs read once (the f32
images, the labels at one byte) and its output written once (labels, one
byte).
"""

from __future__ import annotations

from portbench.reference.crf import Geometry


def flops(c: dict, B: int, h: int, w: int, L: int) -> float:
    g = Geometry(h, w, c)
    nc, s, it = g.nc, g.stride, c["n_iters"]
    Z, P = g.ny * g.nx, g.cs_y * g.cs_x
    Ps, C, D = P // (s * s), nc * nc, nc * L
    BZ = B * Z
    nt = len(g.ctaps)
    stencil = 2 * (nt * nt + nt)
    npl = BZ * L * P
    ops = 2 * 8 * BZ * Ps                                    # norm splat
    ops += it * 2 * 8 * BZ * L * Ps                          # Q splats
    ops += 2 * 8 * BZ * P + 2 * 2 * BZ * P + stencil * BZ * nc * C  # norm
    ops += it * 2 * (2 * len(g.gtaps) + 1) * npl             # spatial blur
    ops += it * (2 * 8 * npl + 2 * 2 * npl + stencil * BZ * D * C
                 + 20 * npl)                                 # steps
    ops += 2 * B * Z * Z * nc * C + it * 2 * B * Z * Z * D * C   # z blur
    return float(ops)


def io_bytes(B: int, h: int, w: int) -> float:
    return float(B * h * w * (3 * 4 + 1 + 1))
