"""Height-sharded frames: halo exchange and the sharded streaming runner
(crfp_tpu/parallel/spatial.py).

Each rank holds a band of rows of one frame. :func:`halo_exchange` pads a
band with ``halo`` rows from its neighbours (zeros, or the band's own edge
row, at the frame's edges) with one ``all_gather`` of every rank's edge
rows: NCCL and gloo both take CUDA tensors for it, where gloo's
send/recv take CPU tensors only. :func:`sharded_conv3x3` is the exact
'same' 3x3 conv over a band: ``F.conv2d`` on the haloed band, padded in W
only.

:class:`SpatialStreamingRunner` runs the whole streaming step of ``CRFP``
with every frame-shaped tensor and the recurrent state height-sharded.
The JAX runner compiles the step under GSPMD, which inserts the halos;
here the model code and the kernels run unchanged on the rank's band
under a ``TorchFunctionMode`` that gives each operation reading across
rows its rows first and crops after:

- bands are whole LR rows, so every 8x, 1/4-size and LR plane splits at
  whole pixels, and ``pixel_shuffle``/``pixel_unshuffle``, the 2x max pool
  and the integer-factor bilinear downsamples (``align_corners=False``) are
  row-local; an integer-factor bilinear upsample takes one halo row (the
  edge row repeated at the frame's edges, as the resize clamps there);
- a conv of kernel k takes k // 2 halo rows and is padded in W only;
- a windowed warp or DCN (``dcn_window``, ``dcn_window_hr``) takes
  ``window + k // 2 + 1`` rows at its level, with zero offsets, mask and
  flow on the halo rows; an unclamped one takes the whole height,
  all-gathered (DCN offsets are ``10 tanh + flow``, unbounded). The kernel
  runs on that slab and the rank's rows are cropped out, contiguous: each
  output pixel reads only its own offset and its own window, so the crop
  is exact;
- an anchored warp or DCN (``ModelConfig.dcn_anchor``) takes the whole
  height, all-gathered, and so do its offsets, mask and flow: each
  anchor is the mean of a cell of the TPU kernel's grid, which counts
  rows from the frame's top and can span two bands (720p over two ranks:
  360 HR rows a band, and the 32-row cell at rows 352-383), so it reads
  rows of the neighbouring band. The cell grid does not depend on the
  height (:func:`crfp_torch.ops.anchor.anchor_geometry`), so the geometry
  the model builds on its band is the frame's;
- the flow net runs on the whole LR pair on every rank (``nn/flow.py``
  resizes with ``align_corners=True`` over a 6-level pyramid, so its reach
  is the frame; the LR frame is 1/64 of the 8x pixels) and each rank keeps
  its rows of the flow;
- elementwise and channel operations pass; an operation on the height
  axis, or one the mode does not know, raises: the runner never computes
  on a band as if the band were the frame.

Heights: the LR height must divide evenly over the ranks, as JAX's
``device_put`` onto ``P(None, 'data')`` requires of every sharded plane.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from crfp_torch.models.layout import nchw
from crfp_torch.ops.cuda.dcn import deform_conv2d_windowed
from crfp_torch.ops.cuda.dcn_fused import deform_conv2d_fusedprep
from crfp_torch.ops.cuda.warp import flow_warp_windowed
from crfp_torch.parallel.sharding import group_of


def _world_rank(group) -> tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


def halo_exchange(x: torch.Tensor, halo: int, group=None, axis: int = 1,
                  edge: str = "zeros") -> torch.Tensor:
    """Pad this rank's band ``x`` (rows along ``axis``; NHWC: 1) with
    ``halo`` rows from the neighbouring ranks' bands, in rank order, and at
    the frame's top and bottom with zeros (``edge='zeros'``) or the band's
    own edge row repeated (``'replicate'``). Every rank of ``group`` calls it
    with bands of equal shape. Returns ``rows + 2 * halo`` rows."""
    if edge not in ("zeros", "replicate"):
        raise ValueError(f"halo_exchange: edge={edge!r}")
    if halo == 0:
        return x
    rows = x.shape[axis]
    if halo > rows:
        raise ValueError(f"halo_exchange: halo {halo} exceeds the band's {rows} rows")
    world, rank = _world_rank(group)
    edges = torch.cat([x.narrow(axis, 0, halo), x.narrow(axis, rows - halo, halo)],
                      dim=axis).contiguous()
    parts = [torch.empty_like(edges) for _ in range(world)]
    dist.all_gather(parts, edges, group=group)

    def outside(row: int) -> torch.Tensor:
        if edge == "zeros":
            shape = list(x.shape)
            shape[axis] = halo
            return x.new_zeros(shape)
        return torch.repeat_interleave(x.narrow(axis, row, 1), halo, dim=axis)

    above = parts[rank - 1].narrow(axis, halo, halo) if rank > 0 else outside(0)
    below = parts[rank + 1].narrow(axis, 0, halo) if rank < world - 1 else outside(rows - 1)
    return torch.cat([above, x, below], dim=axis)


def gather_rows(x: torch.Tensor, group=None, axis: int = 1) -> torch.Tensor:
    """The whole frame from every rank's equal band (rows along ``axis``)."""
    world, _ = _world_rank(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=axis)


def shard_frame_height(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's band of the NHWC ``x`` (N, H, W, C), contiguous. H must
    divide evenly over the ranks."""
    world, rank = _world_rank(group_of(group))
    h = x.shape[1]
    if h % world:
        raise ValueError(f"shard_frame_height: height {h} does not divide evenly over "
                         f"{world} ranks")
    return x[:, rank * (h // world):(rank + 1) * (h // world)].contiguous()


def sharded_conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                    group=None) -> torch.Tensor:
    """'same' 3x3 conv over this rank's NHWC band ``x`` (N, rows, W, C),
    exact through one halo row: ``weight`` (O, C, 3, 3), ``bias`` (O,) or
    None, replicated. Returns the band of the output, (N, rows, W, O)."""
    group = group_of(group)
    xs = halo_exchange(x, 1, group, axis=1).permute(0, 3, 1, 2)
    return F.conv2d(xs, weight, bias, padding=(0, 1)).permute(0, 2, 3, 1)


# ---- the sharded mode ------------------------------------------------------

# the operations the model's streaming step calls, and no others (any other
# raises): elementwise ones, whose output at a pixel reads only that pixel ...
_POINTWISE = frozenset(("add", "mul", "__rsub__", "tanh", "sigmoid", "relu", "leaky_relu",
                        "float", "to", "contiguous"))
# ... and shape reads and new tensors of the caller's (band) sizes
_PASS = frozenset(("__get__", "new_zeros"))

_H_ATTR = "_crfp_rows_from_end"


def _from_end(t: torch.Tensor) -> int:
    """Where a band's row axis sits, counted from the end (NCHW: 2)."""
    return getattr(t, _H_ATTR, 2)


def _mark(out, from_end: int):
    if isinstance(out, torch.Tensor) and from_end != 2:
        setattr(out, _H_ATTR, from_end)
    return out


def _tensors(args, kwargs) -> list[torch.Tensor]:
    flat = list(args) + list((kwargs or {}).values())
    out = []
    for a in flat:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _norm(dim: int, ndim: int) -> int:
    return dim + ndim if dim < 0 else dim


class _RowBands(TorchFunctionMode):
    """Runs the operations of one model call on this rank's band of rows;
    see the module note. Each exchange calls the module's
    :func:`halo_exchange` (or :func:`gather_rows`) by name."""

    def __init__(self, group):
        super().__init__()
        self.group = group
        self.world, self.rank = _world_rank(group)
        self._special = {
            torch.conv2d: self._conv2d,
            F.interpolate: self._interpolate,
            torch.pixel_shuffle: self._row_local,
            torch.pixel_unshuffle: self._pixel_unshuffle,
            F.max_pool2d: self._pool,
            flow_warp_windowed: self._warp,
            deform_conv2d_windowed: self._dcn,
            deform_conv2d_fusedprep: self._dcn_fused,
            torch.cat: self._cat,
            torch.stack: self._stack,
            torch.chunk: self._chunk,
            torch.Tensor.reshape: self._reshape,
            torch.Tensor.permute: self._permute,
            torch.Tensor.__getitem__: self._getitem,
        }

    def refuse(self, what: str):
        raise NotImplementedError(
            f"SpatialStreamingRunner: {what} is not covered on a band of rows "
            "(crfp_torch/parallel/spatial.py)")

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        handler = self._special.get(func)
        if handler is not None:
            return handler(func, args, kwargs)
        name = getattr(func, "__name__", "")
        if name in _PASS:
            return func(*args, **kwargs)
        if name in _POINTWISE:
            ends = {_from_end(t) for t in _tensors(args, kwargs) if t.dim() >= 2}
            if len(ends) > 1:
                self.refuse(f"{name} over bands with their rows on different axes")
            return _mark(func(*args, **kwargs), ends.pop() if ends else 2)
        self.refuse(getattr(func, "__qualname__", repr(func)))

    # -- layout ops: allowed off the row axis, which they track --------------

    def _rows_axis(self, t: torch.Tensor) -> int:
        return t.dim() - _from_end(t)

    def _cat(self, func, args, kwargs):
        ts = args[0]
        dim = kwargs.get("dim", args[1] if len(args) > 1 else 0)
        ends = {_from_end(t) for t in ts}
        if len(ends) > 1 or _norm(dim, ts[0].dim()) == self._rows_axis(ts[0]):
            self.refuse("cat along the row axis")
        return _mark(func(*args, **kwargs), ends.pop())

    def _stack(self, func, args, kwargs):
        ts = args[0]
        dim = _norm(kwargs.get("dim", args[1] if len(args) > 1 else 0), ts[0].dim() + 1)
        ends = {_from_end(t) for t in ts}
        if len(ends) > 1:
            self.refuse("stack of bands with their rows on different axes")
        end = ends.pop()
        # a new axis after the rows moves them one further from the end
        rows = ts[0].dim() - end
        return _mark(func(*args, **kwargs), end + (dim > rows))

    def _chunk(self, func, args, kwargs):
        t = args[0]
        dim = kwargs.get("dim", args[2] if len(args) > 2 else 0)
        if _norm(dim, t.dim()) == self._rows_axis(t):
            self.refuse("chunk along the row axis")
        return tuple(_mark(o, _from_end(t)) for o in func(*args, **kwargs))

    def _reshape(self, func, args, kwargs):
        t = args[0]
        out = func(*args, **kwargs)
        end = _from_end(t)
        if out.dim() < end or tuple(out.shape[-end:]) != tuple(t.shape[-end:]):
            self.refuse(f"reshape {tuple(t.shape)} -> {tuple(out.shape)} across the row axis")
        return _mark(out, end)

    def _permute(self, func, args, kwargs):
        t = args[0]
        dims = args[1:] if len(args) > 1 else kwargs["dims"]
        if len(dims) == 1 and isinstance(dims[0], (tuple, list)):
            dims = dims[0]
        dims = [_norm(d, t.dim()) for d in dims]
        return _mark(func(*args, **kwargs), t.dim() - dims.index(self._rows_axis(t)))

    def _getitem(self, func, args, kwargs):
        t, index = args
        if t.dim() < 2:
            return func(*args, **kwargs)
        index = index if isinstance(index, tuple) else (index,)
        if any(not (i is None or i is Ellipsis or isinstance(i, (int, slice)))
               for i in index):
            self.refuse("advanced indexing")
        used = sum(i is not None and i is not Ellipsis for i in index)
        if sum(i is Ellipsis for i in index) > 1:
            self.refuse("indexing with two ellipses")
        expanded = []
        for i in index:
            expanded.extend([slice(None)] * (t.dim() - used) if i is Ellipsis else [i])
        expanded.extend([slice(None)] * (t.dim() - sum(i is not None for i in expanded)))
        rows, axis, out_axis = self._rows_axis(t), 0, 0
        out_rows = None
        for i in expanded:
            if i is None:
                out_axis += 1
                continue
            if axis == rows:
                if i != slice(None):
                    self.refuse("indexing the row axis")
                out_rows = out_axis
            out_axis += not isinstance(i, int)
            axis += 1
        out = func(*args, **kwargs)
        return _mark(out, out.dim() - out_rows)

    # -- ops that read across rows: halo, run, crop --------------------------

    def _nchw(self, t: torch.Tensor, what: str) -> None:
        if t.dim() != 4 or _from_end(t) != 2:
            self.refuse(f"{what} on a tensor that is not an NCHW band")

    def _row_local(self, func, args, kwargs):
        self._nchw(args[0], func.__name__)
        return func(*args, **kwargs)

    def _pixel_unshuffle(self, func, args, kwargs):
        x = args[0]
        f = kwargs.get("downscale_factor", args[1] if len(args) > 1 else None)
        self._nchw(x, "pixel_unshuffle")
        if x.shape[2] % f:
            self.refuse(f"pixel_unshuffle by {f} of a band of {x.shape[2]} rows")
        return func(*args, **kwargs)

    def _pool(self, func, args, kwargs):
        x = args[0]
        self._nchw(x, "pooling")
        names = ("kernel_size", "stride", "padding")
        k, stride, pad = (kwargs.get(n, args[i + 1] if len(args) > i + 1 else None)
                          for i, n in enumerate(names))
        pair = (lambda v: tuple(v) if isinstance(v, (tuple, list)) else (v, v))  # noqa: E731
        if (stride is not None and pair(stride) != pair(k)) or pair(pad or 0) != (0, 0) \
                or x.shape[2] % pair(k)[0] or kwargs.get("ceil_mode"):
            self.refuse("pooling other than k x k, stride k, unpadded, over whole blocks")
        return func(*args, **kwargs)

    def _conv2d(self, func, args, kwargs):
        names = ("input", "weight", "bias", "stride", "padding", "dilation", "groups")
        a = dict(zip(names, args))
        a.update(kwargs)
        x, w = a["input"], a["weight"]
        self._nchw(x, "conv2d")
        pair = (lambda v: tuple(v) if isinstance(v, (tuple, list)) else (v, v))  # noqa: E731
        stride, dil = pair(a.get("stride", 1)), pair(a.get("dilation", 1))
        pad = a.get("padding", 0)
        if isinstance(pad, str) or stride != (1, 1) or dil != (1, 1) \
                or w.shape[2] != 2 * pair(pad)[0] + 1:
            self.refuse(f"conv2d with stride {stride}, dilation {dil}, padding {pad!r} "
                        f"and kernel {tuple(w.shape[2:])}")
        ph, pw = pair(pad)
        xs = halo_exchange(x, ph, self.group, axis=2)
        return F.conv2d(xs, w, a.get("bias"), 1, (0, pw), 1, a.get("groups", 1))

    def _interpolate(self, func, args, kwargs):
        names = ("input", "size", "scale_factor", "mode", "align_corners")
        a = dict(zip(names, args))
        a.update(kwargs)
        x, size = a["input"], a.get("size")
        self._nchw(x, "interpolate")
        if (a.get("mode") != "bilinear" or a.get("align_corners") or size is None
                or a.get("scale_factor") is not None or a.get("antialias")):
            self.refuse(f"interpolate other than bilinear to a size "
                        f"(align_corners=False): {a.get('mode')!r}")
        h, oh = x.shape[2], size[0]
        if oh <= h:
            if h % oh:
                self.refuse(f"a bilinear resize of {h} rows to {oh}")
            return func(x, size=tuple(size), mode="bilinear", align_corners=False)
        if oh % h:
            self.refuse(f"a bilinear resize of {h} rows to {oh}")
        r = oh // h
        xs = halo_exchange(x, 1, self.group, axis=2, edge="replicate")
        out = func(xs, size=(oh + 2 * r, size[1]), mode="bilinear", align_corners=False)
        return out[:, :, r:r + oh]

    def _slab(self, x: torch.Tensor, reach: int | None) -> tuple[torch.Tensor, int]:
        """(x with ``reach`` rows of its neighbours' each side, or the whole
        frame, and the offset of this band's first row in it)."""
        rows = x.shape[2]
        if reach is None or reach > rows:
            return gather_rows(x, self.group, axis=2), self.rank * rows
        return halo_exchange(x, reach, self.group, axis=2), reach

    def _zero_pad(self, t: torch.Tensor, total: int, at: int) -> torch.Tensor:
        """``t``'s rows at ``at`` in ``total`` rows of zeros."""
        return F.pad(t, (0, 0, at, total - at - t.shape[2])).contiguous()

    def _side_rows(self, t: torch.Tensor, total: int, at: int, whole: bool) -> torch.Tensor:
        """A side operand (offsets, mask, flow) over a slab of ``total``
        rows: the whole frame's, all-gathered (``whole``: an anchored call,
        whose cell means read the rows of every band a cell spans), or this
        band's rows at ``at`` in zeros (each output pixel reads only its own
        offset)."""
        if whole:
            return gather_rows(t, self.group, axis=2)
        return self._zero_pad(t, total, at)

    def _on_slab(self, func, x, side, reach, call, anchored=False):
        """Run ``call(slab, *side operands over the slab)`` and crop this
        band; ``anchored``: the whole frame, side operands too."""
        for t in (x, *side):
            self._nchw(t, func.__name__)
        slab, at = self._slab(x, None if anchored else reach)
        side = [self._side_rows(t, slab.shape[2], at, anchored) for t in side]
        out = call(slab.contiguous(), *side)
        return out[:, :, at:at + x.shape[2]].contiguous()

    @staticmethod
    def _reach(window: int | None, kh: int) -> int | None:
        return None if window is None else int(window) + kh // 2 + 1

    def _warp(self, func, args, kwargs):
        a = dict(zip(("x", "flow", "max_displacement", "anchor"), args))
        a.update(kwargs)
        d, anchor = a["max_displacement"], a.get("anchor")
        return self._on_slab(func, a["x"], (a["flow"],), self._reach(d, 3),
                             lambda x, f: func(x, f, d, anchor=anchor),
                             anchored=anchor is not None)

    def _dcn(self, func, args, kwargs):
        a = dict(zip(("x", "offset", "mask", "weight", "bias"), args))
        a.update(kwargs)
        kw = {k: v for k, v in a.items() if k not in ("x", "offset", "mask")}
        return self._on_slab(func, a["x"], (a["offset"], a["mask"]),
                             self._reach(a.get("max_displacement"), a["weight"].shape[2]),
                             lambda x, o, m: func(x, o, m, **kw),
                             anchored=a.get("anchor") is not None)

    def _dcn_fused(self, func, args, kwargs):
        a = dict(zip(("x", "raw_offset", "raw_mask", "flow", "weight", "bias"), args))
        a.update(kwargs)
        side = ("raw_offset", "raw_mask", "flow")
        kw = {k: v for k, v in a.items() if k not in ("x", *side, "plan")}
        return self._on_slab(func, a["x"], tuple(a[k] for k in side),
                             self._reach(a.get("max_displacement"), a["weight"].shape[2]),
                             lambda x, o, m, f: func(x, o, m, f, **kw))


class SpatialStreamingRunner:
    """``runner(lr, fv, mk)``: one frame in, one 8x frame out, as
    :class:`crfp_torch.models.streaming.StreamingRunner` (NHWC with the batch
    dimension: lr (N, h, w, 3), fv (N, 8h, 8w, 3), mk (N, 8h, 8w, 1) ->
    (N, 8h, 8w, 3)), with the frame split by height over the ranks of
    ``group`` (a process group or a ``data`` mesh; None: the world).

    Every rank passes the whole frame and gets the whole output frame back
    (all-gathered, as the JAX runner returns a global array); it computes
    and keeps only its band: LR rows ``[rank * h / world, (rank + 1) * h /
    world)`` and the matching rows of every other plane and of the
    recurrent state. ``clear_states()`` restarts the clip. No ``fg``: as in
    the JAX runner, regional gating is not taken."""

    def __init__(self, model, group=None):
        self.model = model.eval()
        self.group = group_of(group)
        self.world, self.rank = _world_rank(self.group)
        self._mode = _RowBands(self.group)
        self._state = None
        self._pre_lr: torch.Tensor | None = None

    def clear_states(self) -> None:
        self._state = None
        self._pre_lr = None

    @torch.no_grad()
    def __call__(self, lr, fv, mk) -> torch.Tensor:
        p = next(self.model.parameters())
        lr, fv, mk = (nchw(torch.as_tensor(a).to(p.device, p.dtype)) for a in (lr, fv, mk))
        h = lr.shape[2]
        if h % self.world:
            raise ValueError(f"SpatialStreamingRunner: {h} LR rows do not divide evenly "
                             f"over {self.world} ranks")
        rows = h // self.world
        s = fv.shape[2] // h

        def band(t, f):
            return t[:, :, self.rank * rows * f:(self.rank + 1) * rows * f].contiguous()

        lr_b, fv_b, mk_b = band(lr, 1), band(fv, s), band(mk, s)
        model = self.model
        flow = None
        if self._state is not None:
            # the flow net on the whole LR pair, on every rank alike
            flow = band(model.compute_flow(lr, self._pre_lr), 1)
        with self._mode:
            x_lr, x_hr = model.encode_frame(lr_b, fv_b, mk_b)
            if self._state is None:
                self._state, out = model.step0(lr_b, x_lr, x_hr, mk_b)
            else:
                self._state, out = model.step(self._state, lr_b, x_lr, x_hr, mk_b, flow,
                                              None)
        self._pre_lr = lr
        return gather_rows(out, self.group, axis=2).permute(0, 2, 3, 1)
