"""Height (spatial) sharding: bands of image rows and their halo exchange
(the port of the JAX package's ``spatial=True``, where XLA's SPMD
partitioner inserts the exchanges).

The ``space`` processes of a data slot (``parallel/mesh.py``) hold the same
images, and each runs the net on one band of their rows.  Band boundaries
fall on multiples of the net's largest stride, ``unit`` (8 for
MobileNetV2, the output stride for Xception): the deepest map's
``ceil(H / unit)`` rows are split as evenly as possible, the last band
taking the remainder, so a map at stride ``s`` holds rows ``[A / s,
ceil(B / s))`` of the band ``[A, B)`` of image rows, out of ``ceil(H / s)``.

Every op that reads across rows gets the rows it reads from the processes
that own them (:func:`exchange`): an op with kernel ``k``, rate ``r``,
stride ``s`` and global pads ``(lo, hi)`` computes output rows ``[a, b)``
from the global input rows ``[a*s - lo, (b-1)*s - lo + k_eff)``, rows
outside the map being zeros: SAME and the fixed pads exactly.  The halo may
be deeper than a band: the rows come from as many processes as own them.
The exchange is an autograd function whose backward returns each halo
row's gradient to its owner, which adds it.  It is one ``all_gather`` over
the space group a direction (each process's pieces for the others, padded
to the longest), a collective that NCCL and gloo both take.

``banded(net, band)`` puts the net under a band: its convs exchange their
rows, ASPP's image pool sums over the space group, the TF1 resizes read
their neighbours' rows, dropout draws the whole map's mask and keeps the
band's rows, and the fused serving kernels run on the band extended by
their halo inside the image (:func:`on_halo`).  BN, the loss and the
metrics sum over the mesh as the Trainer sets them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from deeplab_tpu_torch.ops.bn import _AllSum
from deeplab_tpu_torch.ops.padding import effective_kernel
from deeplab_tpu_torch.parallel.mesh import Mesh, all_gather


def unit_of(net) -> int:
    """The net's largest stride, where band boundaries fall."""
    return net.OS if net.backbone == "xception" else 8


def band_bounds(H: int, unit: int, space: int):
    """The image rows ``[(A, B), ...]`` of the ``space`` bands of an image
    ``H`` rows high."""
    deep = math.ceil(H / unit)
    if deep < space:
        raise ValueError(f"{H} rows give {deep} rows at stride {unit}: too "
                         f"few for {space} bands")
    cuts = [k * deep // space for k in range(space + 1)]
    return tuple((unit * cuts[k], min(unit * cuts[k + 1], H))
                 for k in range(space))


def _levels(unit: int):
    s, out = 1, []
    while s <= unit:
        out.append(s)
        s *= 2
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Band:
    """This process's band of the images of its data slot: ``mesh`` (its
    ``space_index`` is the band's), the image height ``H``, the ``unit``
    and every band's image rows ``bounds``.  A map's stride ``s`` is its
    level; a band map's level follows from its height (the heights of a
    band at the levels 1, 2, ..., unit differ, which :meth:`of` checks)."""
    mesh: Mesh
    H: int
    unit: int
    bounds: tuple

    @classmethod
    def of(cls, mesh: Mesh, H: int, unit: int) -> "Band":
        bounds = band_bounds(H, unit, mesh.space)
        band = cls(mesh, H, unit, bounds)
        for j in range(mesh.space):
            heights = [band.rows(s, j) for s in _levels(unit)]
            heights = [b - a for a, b in heights]
            if len(set(heights)) != len(heights):
                raise ValueError(f"band {j} of {bounds} ({H} rows, unit "
                                 f"{unit}) has the same height at two "
                                 f"strides: use fewer space processes")
        sizes = [band.size(s) for s in _levels(unit)]
        if len(set(sizes)) != len(sizes):
            raise ValueError(f"{H} rows are too few for unit {unit}")
        return band

    @property
    def index(self) -> int:
        return self.mesh.space_index

    @property
    def start(self) -> int:
        return self.bounds[self.index][0]

    @property
    def stop(self) -> int:
        return self.bounds[self.index][1]

    def size(self, s: int) -> int:
        """The whole map's height at stride ``s``."""
        return math.ceil(self.H / s)

    def rows(self, s: int, j: int = None):
        """Band ``j``'s (default: this one's) rows ``(a, b)`` of the map at
        stride ``s``."""
        A, B = self.bounds[self.index if j is None else j]
        if A % s:
            raise ValueError(f"stride {s} does not divide the band start "
                             f"{A}")
        return A // s, math.ceil(B / s)

    def level(self, h: int) -> int:
        """The stride of this band's map of height ``h``."""
        for s in _levels(self.unit):
            a, b = self.rows(s)
            if b - a == h:
                return s
        raise ValueError(f"no map of band {self.bounds[self.index]} is "
                         f"{h} rows high")

    def level_of_size(self, n: int) -> int:
        """The stride of a whole map ``n`` rows high."""
        for s in _levels(self.unit):
            if self.size(s) == n:
                return s
        raise ValueError(f"no map of a {self.H}-row image is {n} rows high")

    def take(self, t, dim: int = 1):
        """This band's rows of a whole image (``dim`` its rows, stride
        1): images, labels, weights."""
        return t.narrow(dim, self.start, self.stop - self.start)

    def gather(self, t: torch.Tensor, dim: int = 1, s: int = 1):
        """Every band's ``t`` (a map at stride ``s``, rows along ``dim``)
        concatenated: the whole map, on every space process."""
        sizes = [b - a for a, b in (self.rows(s, j)
                                    for j in range(self.mesh.space))]
        return self.mesh.space_gather(t, sizes, dim)


# ---------------------------------------------------------------- exchange --

def _sends(band: Band, s: int, needs):
    """``sends[i][j]``: the global rows ``(r0, r1)`` band ``i`` sends band
    ``j`` (None for nothing), for the rows ``needs[j]`` each band reads."""
    n = band.mesh.space
    own = [band.rows(s, j) for j in range(n)]
    sends = [[None] * n for _ in range(n)]
    for j, (g0, g1) in enumerate(needs):
        for i, (a, b) in enumerate(own):
            r0, r1 = max(g0, a), min(g1, b)
            if i != j and r0 < r1:
                sends[i][j] = (r0, r1)
    return own, sends


def _span(r):
    return 0 if r is None else r[1] - r[0]


def _rows_zeros(x, n):
    """Zeros shaped as ``x`` with ``n`` rows, in its memory format."""
    mf = (torch.channels_last if not x.is_contiguous()
          and x.is_contiguous(memory_format=torch.channels_last)
          else torch.contiguous_format)
    return torch.empty((x.shape[0], x.shape[1], n, x.shape[3]),
                       dtype=x.dtype, device=x.device,
                       memory_format=mf).zero_()


def _swap(pieces, like, total, band):
    """All-gather this process's ``pieces`` (row slices of one map's
    layout) one after another, padded to ``total`` rows: every space
    process's buffer."""
    buf = like.new_zeros((like.shape[0], like.shape[1], total,
                          like.shape[3]))
    at = 0
    for p in pieces:
        buf[:, :, at:at + p.shape[2]] = p
        at += p.shape[2]
    m = band.mesh
    return all_gather(buf, m.space_group, m.host_transport)


def _fetch(x, band, s, needs):
    me = band.index
    own, sends = _sends(band, s, needs)
    a, b = own[me]
    g0, g1 = needs[me]
    out = _rows_zeros(x, g1 - g0)
    lo, hi = max(g0, a), min(g1, b)
    if lo < hi:
        out[:, :, lo - g0:hi - g0] = x[:, :, lo - a:hi - a]
    total = max(sum(_span(r) for r in row) for row in sends)
    if total:
        parts = _swap([x[:, :, r[0] - a:r[1] - a] for r in sends[me] if r],
                      x, total, band)
        for i, part in enumerate(parts):
            r = sends[i][me]
            if r is not None:
                off = sum(_span(sends[i][j]) for j in range(me))
                out[:, :, r[0] - g0:r[1] - g0] = \
                    part[:, :, off:off + r[1] - r[0]]
    return out


def _return(g, band, s, needs):
    me = band.index
    n = band.mesh.space
    own, sends = _sends(band, s, needs)
    a, b = own[me]
    g0, g1 = needs[me]
    gx = _rows_zeros(g, b - a)
    lo, hi = max(g0, a), min(g1, b)
    if lo < hi:
        gx[:, :, lo - a:hi - a] += g[:, :, lo - g0:hi - g0]
    total = max(sum(_span(sends[i][j]) for i in range(n)) for j in range(n))
    if total:
        came = [sends[i][me] for i in range(n)]
        parts = _swap([g[:, :, r[0] - g0:r[1] - g0] for r in came if r],
                      g, total, band)
        for j, part in enumerate(parts):
            r = sends[me][j]
            if r is not None:
                off = sum(_span(sends[i][j]) for i in range(me))
                gx[:, :, r[0] - a:r[1] - a] += \
                    part[:, :, off:off + r[1] - r[0]]
    return gx


class _Exchange(torch.autograd.Function):
    """Rows ``needs[me]`` of the map whose band this process holds; the
    backward returns each fetched row's gradient to its owner."""

    @staticmethod
    def forward(ctx, x, band, s, needs):
        ctx.band, ctx.s, ctx.needs = band, s, needs
        return _fetch(x, band, s, needs)

    @staticmethod
    def backward(ctx, g):
        return _return(g, ctx.band, ctx.s, ctx.needs), None, None, None


def exchange(x: torch.Tensor, band: Band, s: int, need) -> torch.Tensor:
    """The global rows ``need(j)`` of the NCHW map at stride ``s`` whose
    band ``x`` is, for this process's band ``j``; rows outside the map are
    zeros.  ``need`` maps every band index to its rows: each process plans
    every transfer.  Every space process must call it, in the same
    order."""
    needs = [tuple(need(j)) for j in range(band.mesh.space)]
    if all(needs[j] == band.rows(s, j) for j in range(band.mesh.space)):
        return x
    return _Exchange.apply(x, band, s, needs)


def conv_rows(x, band: Band, k: int, stride: int, rate: int, pads_h):
    """``x`` (a band map) extended to the rows a conv reads: kernel ``k``
    at ``rate`` and ``stride`` with the whole map's pads ``pads_h`` on the
    rows.  The conv then runs VALID on the rows."""
    s = band.level(x.shape[2])
    keff = effective_kernel(k, rate)
    lo = pads_h[0]

    def need(j):
        oa, ob = band.rows(s * stride, j)
        return oa * stride - lo, (ob - 1) * stride - lo + keff
    return exchange(x, band, s, need)


def map_height(x: torch.Tensor, band) -> int:
    """The height of the map whose band ``x`` is (``x``'s own without a
    band)."""
    if band is None:
        return x.shape[2]
    return band.size(band.level(x.shape[2]))


def on_halo(fn, x, band, halo: int, multiple: int = 1):
    """``fn(x)``, where ``fn`` is a stride-1 op that reads ``halo`` rows up
    and down and zero pads its input at the map's edges.  Under ``band``
    it runs on the band extended by up to ``halo`` rows on each side,
    never past the map's edges (there ``fn``'s own zero padding is the
    right one: SAME pads what ``fn`` reads inside, which may differ from
    ``fn`` of zero rows), and the extra rows are cropped.  ``multiple``:
    the extended rows are padded up to a multiple of it (a kernel's shape
    condition) with more of the map's rows, below and then above, rows the
    kept outputs never read; the map's height must be a multiple of it."""
    if band is None:
        return fn(x)
    s = band.level(x.shape[2])
    size = band.size(s)
    if size % multiple:
        raise ValueError(f"a map of {size} rows is not a multiple of "
                         f"{multiple}")

    def need(j):
        a, b = band.rows(s, j)
        g0, g1 = max(a - halo, 0), min(b + halo, size)
        extra = -(g1 - g0) % multiple
        down = min(extra, size - g1)
        return g0 - (extra - down), g1 + down
    a, b = band.rows(s)
    g0 = need(band.index)[0]
    out = fn(exchange(x, band, s, need))
    return out[:, :, a - g0:b - g0]


def image_mean(x: torch.Tensor, band: Band) -> torch.Tensor:
    """The whole image's mean of the band map ``x`` over its rows and
    columns, (B, C, 1, 1): the band's sums over the space group (under
    autograd, the gradient summed back the same way)."""
    n = band.size(band.level(x.shape[2])) * x.shape[3]
    sums = _AllSum.apply(x.float().sum(dim=(2, 3), keepdim=True),
                         band.mesh.space_axis())
    return (sums / n).to(x.dtype)


def check_same_images(mesh: Mesh, *ts: torch.Tensor):
    """Raise ``ValueError`` unless every space process of this data slot
    holds the same batches ``ts`` (each image's sum, compared over the
    space group): a band of another image's rows would train without
    error.  Generators shard their files by data slot with ``host_id=
    mesh.data_index, num_hosts=mesh.data``."""
    sums = torch.cat([t.detach().reshape(t.shape[0], -1).double().sum(1)
                      for t in ts])
    every = mesh.space_gather(sums[None])
    if not bool((every == every[:1]).all()):
        raise ValueError(
            f"the {mesh.space} space processes of data slot "
            f"{mesh.data_index} hold different images: give each process "
            f"its slot's (generators: host_id=mesh.data_index, "
            f"num_hosts=mesh.data)")


@contextlib.contextmanager
def banded(net, band):
    """Within the block, ``net`` computes on ``band`` (None: the whole
    image): every module that reads across rows takes it."""
    mods = [m for m in net.modules() if hasattr(type(m), "band")]
    saved = [m.band for m in mods]
    for m in mods:
        m.band = band
    try:
        yield
    finally:
        for m, b in zip(mods, saved):
            m.band = b
