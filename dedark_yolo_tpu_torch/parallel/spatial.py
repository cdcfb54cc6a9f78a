"""Row-sharded inference of one large image over a mesh's devices (JAX
parallel/spatial.py), and the train forward of data x spatial training.

JAX shards one image's rows over the mesh and lets GSPMD partition every
convolution, inserting the halo exchanges at the shard boundaries. The port
does the same by hand, as a row-slab executor in lockstep: shard k holds rows
[k*H/n, (k+1)*H/n) of every activation on its device (`RowSlabs`), and each
op runs once per slab, in order:

  - an op with a vertical extent (conv, max pool, transposed conv, pad)
    first takes the rows it reads beyond its slab from the neighbouring
    slabs (`.to(device, non_blocking=True)` of their edge rows, from
    further out where a neighbour is shorter than the halo), pads only at
    the image's true top and bottom (zeros, or -inf under a max pool) and
    keeps the rows of its slab; a stride-2 op reads a halo above and none
    below, since slab boundaries stay on the stride;
  - a row-local op (pointwise, channel slices and concats, BN in eval, the
    integer nearest upsample) runs on each slab as it is;
  - a reduction over H x W (CBAM's and CRU's channel means, Classify's
    mean, SCConv's group statistics through `_group_norm`'s hook) sums
    over every slab;
  - a module that mixes every position (AIFI, C3TR's TransformerBlock,
    RT-DETR's decoder) runs on the map joined by rows on the first device
    and is split again after: exact, as GSPMD's all-gather there;
  - layer 0 (`LowlightRecovery`'s hook, `_lowlight`): the 256x256 resize
    computes each output row from the source rows it reads, the 256 rows
    join on the first device for ExtractParameters2, and the enhance
    kernel (or 'reference''s point chain and usm kernel) runs on each slab
    extended by the blur's 12-row radius of raw input from its neighbours,
    those rows cropped after;
  - the head's raw maps join by rows on the first device, where the decode
    builds its anchors once.

The modules are the model's own: nothing changes in their code, and with
no slabs in play every forward is what it was. The slabs dispatch torch's
functions to the per-slab work through `__torch_function__`; an op that
this executor does not know raises, rather than run on a joined map.

    mesh = make_mesh(devices=["cuda:0", "cuda:1"], axes=("spatial",))
    h = spatial_pad_to(2160, 2)                     # 2176
    boxes, scores = spatial_infer(model, img, mesh)  # img (1, h, W, 3)

A device may repeat in the mesh (`["cuda:0"] * 4`): the slabs then share
it, which shows the partition but not the memory saving of several cards.
The weights are copied once to each distinct device other than the
model's and kept per model, refreshed when its state changes.

Training (`spatial_train`, JAX `shard_batch`'s P(data, spatial) image
leaves under GSPMD) runs the same executor with autograd on: the halo
rows are `.to` and `cat`, which autograd differentiates, and a weight
reaches a slab's device by `.to` inside the graph (no replica: a copy's
gradient would never reach the model's), so every gradient sums over the
slabs on the model's device; train-mode BatchNorm takes its moments over
every slab (`nn/layers.py::BatchNorm._global`, then over the group's
ranks); layer 0 takes the trainer's priors, dedark_A whole and IcA cut
with each slab's extended rows; the head's raw maps join on the first
device for the loss, and the backward of the join splits their gradient
back, counting it once.

Across ranks (a mesh whose 'spatial' axis runs over ranks, one device a
rank: `parallel/mesh.py::rank_spatial_mesh`) each rank holds its own slab
only (`rank_slab`), and every operation that reads another slab is a sum
all-reduce over the spatial group of a zeroed buffer in which each rank
has placed its part (`_placed`): a halo is the rows the other slabs read
of each rank's slab (`_Halo`, one autograd node a halo op, within one
process too), a join the whole map, a reduction over H x W the stack of
the slabs' partial results, summed in slab order as the local executor
sums them. A sum all-reduce's backward is an
all-reduce of the gradient (`_AllReduce`), so each slab's gradient is the
sum of what every rank's use of its rows gives back, and every rank builds
the same autograd graph (no op depends on the slab's place), so the
backward's collectives come in the same order on every rank. What is
computed alike on every rank (after a join: the heads, RT-DETR's decoder;
layer 0's parameter CNN) gives every rank the whole of its gradient:
summed over the spatial group, every gradient is sp times the step's,
which the trainer's gradient bucket divides back (`BaseTrainer.step`).
"""

from __future__ import annotations

import contextlib
import copy
import weakref

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import Mesh, make_mesh

# the ops a slab runs as it is: pointwise, dtype and layout changes
_LOCAL = frozenset("""
    add sub mul div true_divide neg exp log sigmoid tanh relu silu
    leaky_relu gelu hardswish hardsigmoid sqrt rsqrt abs clamp clamp_min
    clamp_max clip where pow reciprocal ge gt le lt eq ne logical_and
    logical_or logical_not maximum minimum sign floor round to float half
    bfloat16 type type_as contiguous clone detach zeros_like ones_like
    full_like empty_like linear
    __add__ __radd__ __iadd__ __sub__ __rsub__ __isub__ __mul__ __rmul__
    __imul__ __truediv__ __rtruediv__ __itruediv__ __neg__ __pow__
    __rpow__ __ge__ __gt__ __le__ __lt__ __and__ __or__ __xor__
    __invert__""".split())
_BINOPS = ("__add__ __radd__ __sub__ __rsub__ __mul__ __rmul__ __truediv__ "
           "__rtruediv__ __neg__ __pow__ __rpow__ __ge__ __gt__ __le__ "
           "__lt__ __and__ __or__ __xor__ __invert__ __getitem__").split()


def spatial_pad_to(h, n_devices, stride=32):
    """Smallest height >= h divisible by stride * n_devices."""
    m = stride * int(n_devices)
    return int(-(-h // m) * m)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _bind(args, kwargs, names, defaults):
    """`args` and `kwargs` of a call as a list in `names`' order."""
    vals = list(args) + [None] * (len(names) - len(args))
    for i, n in enumerate(names):
        if n in kwargs:
            vals[i] = kwargs[n]
        elif i >= len(args):
            vals[i] = defaults.get(n)
    return vals


class Executor:
    """The run's devices and weights: `on(t, dev)` is a tensor on `dev`, a
    weight's copy on that device where the replicas hold one. `devices`
    are those of the slabs this process holds, `slabs` their indices among
    the `n` slabs; across ranks `group` is the spatial group (None
    within one process, where every slab is here)."""

    def __init__(self, devices, copies, slabs=None, n=None, group=None):
        self.devices = devices
        self.copies = copies       # {(id(weight on devices[0]), dev): copy}
        self.slabs = list(range(len(devices)) if slabs is None else slabs)
        self.n = len(devices) if n is None else n
        self.group = group

    def on(self, t, dev):
        if not torch.is_tensor(t) or t.device == dev:
            return t
        hit = self.copies.get((id(t), dev))
        return hit if hit is not None else t.to(dev, non_blocking=True)


class RowSlabs:
    """One map as row slabs: `parts[k]` holds rows [bounds[k],
    bounds[k + 1]) of dimension `hdim` on `ex.devices[k]`. `shape`,
    `dtype` and `device` (the first slab's) are the whole map's."""

    def __init__(self, parts, bounds, hdim, ex):
        self.parts, self.bounds, self.hdim, self.ex = (
            list(parts), list(bounds), hdim, ex)

    # -------------------------------------------------------- the tensor face
    @property
    def shape(self):
        s = list(self.parts[0].shape)
        s[self.hdim] = self.bounds[-1]
        return torch.Size(s)

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self):
        return self.parts[0].device

    @property
    def ndim(self):
        return self.parts[0].dim()

    def dim(self):
        return self.ndim

    def size(self, d=None):
        return self.shape if d is None else self.shape[d]

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        return (f"RowSlabs(shape={tuple(self.shape)}, rows={self.bounds}, "
                f"dim={self.hdim})")

    def __getattr__(self, name):
        fn = getattr(torch.Tensor, name)
        return lambda *a, **k: _dispatch(fn, (self, *a), k)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _dispatch(func, args, kwargs or {})

    # ------------------------------------------------------------ row access
    def rows(self, g0, g1, dev):
        """Global rows [g0, g1) on `dev`, taken from every slab they fall
        in (one slab's own rows are a view); within one process."""
        pieces = []
        for p, s in zip(self.parts, self.ex.slabs):
            a, b = self.bounds[s], self.bounds[s + 1]
            lo, hi = max(a, g0), min(b, g1)
            if lo < hi:
                pieces.append(p.narrow(self.hdim, lo - a, hi - lo).to(
                    dev, non_blocking=True))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, self.hdim)

    def fetch(self, need, fill=0.0):
        """Each held slab's global rows need[s] = (g0, g1) (every slab's
        range; rows outside the image are `fill`) on its device: its own
        rows and those of the slabs around it, in one autograd node
        (`_Halo`); the held slabs themselves where every slab needs just
        its own rows."""
        if all(need[k] == (self.bounds[k], self.bounds[k + 1])
               for k in range(self.ex.n)):
            return list(self.parts)
        return list(_Halo.apply(self, need, fill, *self.parts))

    def join(self, dev=None):
        """The whole map on `dev` (default: the first device); across ranks
        on every rank's device."""
        if self.ex.group is None:
            return self.rows(0, self.bounds[-1], dev or self.ex.devices[0])
        return _placed(self.parts[0], self.ex.slabs[0], np.diff(self.bounds),
                       self.hdim, self.ex.group)

    def sum_over(self, partials):
        """The sum of one whole partial result a held slab, over every
        slab, in slab order, on the first device (across ranks on every
        rank's)."""
        if self.ex.group is None:
            return sum(p.to(self.ex.devices[0]) for p in partials)
        stack = _stack(partials[0], self.ex)
        out = stack[0]
        for k in range(1, self.ex.n):
            out = out + stack[k]
        return out

    def each_partial(self, partials):
        """Every slab's partial result (one a held slab) on the first
        device, in slab order."""
        if self.ex.group is None:
            return [p.to(self.ex.devices[0]) for p in partials]
        return list(_stack(partials[0], self.ex).unbind(0))

    def like(self, parts, bounds=None, hdim=None):
        return RowSlabs(parts, self.bounds if bounds is None else bounds,
                        self.hdim if hdim is None else hdim, self.ex)

    # ------------------------------------------------------------- the hooks
    def group_norm(self, groups, eps):
        """`nn/layers.py::_group_norm` over every slab: each group's mean
        and biased variance summed in f32 over all slabs, then the same
        formula per slab."""
        from ..nn.layers import weak_const
        b, c = self.shape[:2]
        n = (c // groups) * self.shape[2] * self.shape[3]
        xs = [p.reshape(b, groups, -1) for p in self.parts]
        s1 = self.sum_over([x.sum(2, keepdim=True, dtype=torch.float32)
                            for x in xs])
        mean = (s1 / n).to(self.dtype)
        mf = mean.float()
        s2 = self.sum_over([((x.float() - self.ex.on(mf, x.device)) ** 2).sum(
            2, keepdim=True) for x in xs])
        var = (s2 / n).to(self.dtype) * weak_const(n / max(n - 1, 1), mean)
        den = torch.sqrt(var) + weak_const(eps, mean)
        mean, den = _alike(mean, self.ex), _alike(den, self.ex)
        return self.like([((x - self.ex.on(mean, x.device))
                           / self.ex.on(den, x.device)).reshape(p.shape)
                          for x, p in zip(xs, self.parts)])

    def lowlight(self, mod, dedark_A=None, IcA=None):
        """`LowlightRecovery.forward` on NHWC row slabs: see `_lowlight`."""
        return _lowlight(mod, self, dedark_A, IcA)

    def each(self, fn):
        """fn on each slab (an op of the model's own that is row-local but
        no torch function: bf16 training's autograd Functions)."""
        return _map(fn, (self,), {})


for _name in _BINOPS:
    setattr(RowSlabs, _name,
            (lambda fn: lambda self, *a: _dispatch(fn, (self, *a), {}))(
                getattr(torch.Tensor, _name)))


def _slabs_in(obj, out):
    if isinstance(obj, RowSlabs):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _slabs_in(o, out)
    return out


def _swap(obj, k, dev, ref):
    """`obj` with slabs replaced by their k-th part and tensors on `dev`;
    a plain tensor that spans the rows of `ref` raises."""
    if isinstance(obj, RowSlabs):
        return obj.parts[k]
    if isinstance(obj, (list, tuple)):
        return type(obj)(_swap(o, k, dev, ref) for o in obj)
    if torch.is_tensor(obj):
        j = obj.dim() - (ref.ndim - ref.hdim)
        if j >= 0 and obj.shape[j] != 1:
            raise NotImplementedError(
                f"a whole {tuple(obj.shape)} tensor meets row slabs "
                f"{tuple(ref.shape)} along their rows")
        return ref.ex.on(_alike(obj, ref.ex), dev)
    return obj


def _map(func, args, kwargs, hdim_out=None):
    """func on each slab in turn; its tensor outputs as slabs of the same
    rows (a tuple of them for a tuple)."""
    slabs = _slabs_in(list(args) + list(kwargs.values()), [])
    ref = slabs[0]
    for s in slabs[1:]:
        if s.bounds != ref.bounds or s.ex is not ref.ex:
            raise NotImplementedError(
                f"{func.__name__}: slabs of rows {ref.bounds} and "
                f"{s.bounds} do not line up")
    outs = []
    for k, dev in enumerate(ref.ex.devices):
        outs.append(func(*_swap(args, k, dev, ref),
                         **{n: _swap(v, k, dev, ref)
                            for n, v in kwargs.items()}))

    def wrap(parts):
        if torch.is_tensor(parts[0]):
            h = (hdim_out if hdim_out is not None
                 else ref.hdim + parts[0].dim() - ref.ndim)
            return ref.like(parts, hdim=h)
        if isinstance(parts[0], (tuple, list)):
            return type(parts[0])(wrap(list(p)) for p in zip(*parts))
        raise NotImplementedError(f"{func.__name__} on row slabs returned "
                                  f"{type(parts[0]).__name__}")
    return wrap(outs)


def _norm_dim(d, ndim):
    return d + ndim if d < 0 else d


def _dispatch(func, args, kwargs):
    name = getattr(func, "__name__", "")
    handler = _HANDLERS.get(name)
    if handler is not None:
        return handler(func, args, kwargs)
    if name in _LOCAL:
        return _map(func, args, kwargs)
    raise NotImplementedError(
        f"{name or func} is not run on row slabs (parallel/spatial.py); the "
        f"modules that mix every row run joined: {JOINED}")


# ------------------------------------------------- slabs across ranks
class _AllReduce(torch.autograd.Function):
    """A sum all-reduce over `group` whose backward all-reduces the
    gradient (each rank's input reaches every rank's output)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Alike(torch.autograd.Function):
    """Identity on a tensor every rank of the spatial group computes alike
    and then uses for its own slab only (layer 0's parameters, a joined
    module's output): its gradient is averaged over the group, so every
    rank carries the whole of it back through the same computation, as
    the local executor does once (and the gradients, summed over the
    group, stay sp times the step's, as on every other path)."""

    @staticmethod
    def forward(ctx, t, group, n):
        ctx.group, ctx.n = group, n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g / ctx.n, None, None


def _alike(t, ex):
    """`t` (computed alike on every rank) before its use on the held slabs;
    within one process `t` itself."""
    if ex.group is None or not (torch.is_grad_enabled() and t.requires_grad):
        return t
    return _Alike.apply(t, ex.group, ex.n)


def _all_reduce(t, group):
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllReduce.apply(t, group)
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, group=group)
    return t


def _layout(t):
    """The memory format of `t` (an NCHW map may be a channels_last view,
    `nn/graph.py`), which the slabs' exchanges keep: the local executor's
    cuts and joins keep it, and the ops after them round the same only on
    the same layout."""
    return (torch.channels_last if t.dim() == 4 and t.stride(1) < t.stride(3)
            else torch.contiguous_format)


def _placed(t, me, sizes, dim, group):
    """Every rank's `t` joined along `dim` in rank order, on every rank:
    rank `me` puts its `t` (sizes[me] along dim) at its offset in a zeroed
    buffer of sum(sizes), summed over the group."""
    out = _all_reduce(_zeros_around(t, dim, sum(sizes[:me]),
                                    sum(sizes[me + 1:])), group)
    return out.contiguous(memory_format=_layout(t))


def _stack(t, ex):
    """(n, *t.shape): every slab's whole `t` stacked in slab order, on
    every rank."""
    return _placed(t[None], ex.slabs[0], [1] * ex.n, 0, ex.group)


class _Halo(torch.autograd.Function):
    """`RowSlabs.fetch`: each held slab's rows need[s] of the map, from its
    own slab and the others (within one process by `.to` and `cat`; across
    ranks one exchange over the spatial group: every rank places the rows
    of its slab that another slab reads in a zeroed buffer, summed over the
    group). The backward gives each slab one gradient: its own rows' part,
    then what the other slabs' reads of its rows give back, in slab order
    (across ranks summed over the group in one all-reduce), so a slab's
    gradient adds up the same way in one process and across ranks, and
    every rank's graph is the same."""

    @staticmethod
    def forward(ctx, x, need, fill, *parts):
        # the slabs' metadata only: keeping the slabs would keep every halo
        # op's input alive until its backward
        ctx.need, ctx.meta = need, (x.ex, x.hdim, list(x.bounds))
        ctx.parts = [(p.shape, p.dtype, p.device, _layout(p)) for p in parts]
        ex, hd, b = x.ex, x.hdim, x.bounds
        H = b[-1]
        layout = _layout(parts[0])
        if ex.group is None:
            outs = []
            for dev, s in zip(ex.devices, ex.slabs):
                g0, g1 = need[s]
                pieces = [p.narrow(hd, lo - b[j], hi - lo).to(dev)
                          for j, p in zip(ex.slabs, parts)
                          for lo, hi in [(max(b[j], g0), min(b[j + 1], g1))]
                          if lo < hi]
                outs.append(_pad_rows(torch.cat(pieces, hd), hd, -g0,
                                      g1 - H, fill).contiguous(
                                          memory_format=layout))
            return tuple(outs)
        me, part = ex.slabs[0], parts[0]
        ctx.sends = sends = [sorted({g for q in range(ex.n) if q != r
                                     for g in range(max(need[q][0], b[r]),
                                                    min(need[q][1], b[r + 1]))})
                             for r in range(ex.n)]
        offs = np.cumsum([0] + [len(r) for r in sends])
        g0, g1 = max(need[me][0], 0), min(need[me][1], H)
        owner = np.searchsorted(b, np.arange(g0, g1), "right") - 1
        ctx.pos = [offs[-1] + g - b[me] if r == me
                   else offs[r] + sends[r].index(g)
                   for g, r in zip(range(g0, g1), owner)]
        src = part
        if any(sends):
            send = part.index_select(hd, _rows_index(sends[me], b[me], part))
            buf = _zeros_around(send, hd, offs[me], offs[-1] - offs[me + 1])
            dist.all_reduce(buf, group=ex.group)
            src = torch.cat([buf, part], hd)
        ext = src.index_select(hd, torch.tensor(ctx.pos, device=part.device))
        return (_pad_rows(ext, hd, -need[me][0], need[me][1] - H,
                          fill).contiguous(memory_format=layout),)

    @staticmethod
    def backward(ctx, *grads):
        need, (ex, hd, b) = ctx.need, ctx.meta
        zeros = [torch.empty(shape, dtype=dt, device=dev,
                             memory_format=fmt).zero_()
                 for shape, dt, dev, fmt in ctx.parts]
        out = []
        if ex.group is None:
            for j, g in zip(ex.slabs, zeros):
                order = [ex.slabs.index(j)] + [k for k in range(len(grads))
                                               if ex.slabs[k] != j]
                for k in order:
                    s, gk = ex.slabs[k], grads[k]
                    lo, hi = max(b[j], need[s][0]), min(b[j + 1], need[s][1])
                    if gk is None or lo >= hi:
                        continue
                    g.narrow(hd, lo - b[j], hi - lo).add_(gk.narrow(
                        hd, lo - need[s][0], hi - lo).to(g.device))
                out.append(g)
            return (None, None, None, *out)
        me, g, g_ext = ex.slabs[0], zeros[0], grads[0]
        sends = ctx.sends
        n_buf = sum(len(r) for r in sends)
        shape = list(g.shape)
        shape[hd] += n_buf
        src = g.new_zeros(shape)          # the forward's [buffer, slab]
        if g_ext is not None:
            top = max(-need[me][0], 0)
            src.index_add_(hd, torch.tensor(ctx.pos, device=g.device),
                           g_ext.narrow(hd, top, len(ctx.pos)))
        g.add_(src.narrow(hd, n_buf, g.shape[hd]))
        if any(sends):         # the other slabs' reads of this one's rows
            buf = src.narrow(hd, 0, n_buf).contiguous()
            dist.all_reduce(buf, group=ex.group)
            g.index_add_(hd, _rows_index(sends[me], b[me], g), buf.narrow(
                hd, sum(len(r) for r in sends[:me]), len(sends[me])))
        return (None, None, None, g)


def _rows_index(rows, first, t):
    return torch.tensor([g - first for g in rows], dtype=torch.long,
                        device=t.device)


def _zeros_around(t, dim, before, after):
    shape = list(t.shape)
    zeros = lambda k: t.new_zeros(shape[:dim] + [int(k)] + shape[dim + 1:])
    return torch.cat([zeros(before), t, zeros(after)], dim)


def _pad_rows(t, dim, top, bot, fill):
    """`t` with max(top, 0) rows of `fill` above and max(bot, 0) below."""
    top, bot = max(top, 0), max(bot, 0)
    if not (top or bot):
        return t
    return F.pad(t, [0, 0] * (t.dim() - 1 - dim) + [top, bot], value=fill)


# ------------------------------------------------------ ops with a halo
def _halo(x, k_eff, stride, pad_top, pad_bot, fill, op):
    """The slabs of an op that reads k_eff rows (stride, H padding) per
    output row: output row o belongs to the slab that holds input row
    o * stride; each slab reads its rows and the halo around them, padded
    with `fill` only past the image's edges, and `op(ext)` runs with no
    H padding."""
    H = x.bounds[-1]
    h_out = (H + pad_top + pad_bot - k_eff) // stride + 1
    cuts = ([0] + [min(max(-(-b // stride), 0), h_out)
                   for b in x.bounds[1:-1]] + [h_out])
    spans = []
    for k in range(x.ex.n):
        o0, o1 = cuts[k], cuts[k + 1]
        if o1 <= o0:
            raise ValueError(
                f"slab {k} of rows {x.bounds} holds no output row of a "
                f"{k_eff}-row stride-{stride} op: the image is too short "
                f"for {x.ex.n} slabs")
        spans.append((o0 * stride - pad_top,
                      (o1 - 1) * stride - pad_top + k_eff))
    return x.like([op(ext) for ext in x.fetch(spans, fill)], cuts)


def _conv2d(func, args, kwargs):
    x, w, b, stride, padding, dilation, groups = _bind(
        args, kwargs, ("input", "weight", "bias", "stride", "padding",
                       "dilation", "groups"),
        {"stride": 1, "padding": 0, "dilation": 1, "groups": 1})
    if isinstance(padding, str) or x.hdim != 2:
        raise NotImplementedError("conv2d on row slabs takes NCHW slabs and "
                                  "integer padding")
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    k_eff = dh * (w.shape[2] - 1) + 1
    ex = x.ex
    return _halo(x, k_eff, sh, ph, ph, 0.0, lambda ext: F.conv2d(
        ext, ex.on(w, ext.device), ex.on(b, ext.device), (sh, sw), (0, pw),
        (dh, dw), groups))


def _max_pool2d(func, args, kwargs):
    x, ks, stride, padding, dilation, ceil_mode, ret = _bind(
        args, kwargs, ("input", "kernel_size", "stride", "padding",
                       "dilation", "ceil_mode", "return_indices"),
        {"padding": 0, "dilation": 1, "ceil_mode": False,
         "return_indices": False})
    if ceil_mode or ret or x.hdim != 2:
        raise NotImplementedError("max_pool2d on row slabs: NCHW, no "
                                  "ceil_mode, no indices")
    (kh, kw) = _pair(ks)
    (sh, sw) = _pair(stride if stride not in (None, []) else ks)
    (ph, pw), (dh, dw) = _pair(padding), _pair(dilation)
    return _halo(x, dh * (kh - 1) + 1, sh, ph, ph, float("-inf"),
                 lambda ext: F.max_pool2d(ext, (kh, kw), (sh, sw),
                                             (0, pw), (dh, dw)))


def _conv_transpose2d(func, args, kwargs):
    """A transposed conv whose kernel rows equal its stride: each input row
    makes its own `stride` output rows, so each slab runs alone with no H
    padding and the padding's rows are cropped at the image's true top and
    bottom only (flax's 2H - 2 of ConvTranspose and Proto: uneven slabs)."""
    x, w, b, stride, padding, out_pad, groups, dilation = _bind(
        args, kwargs, ("input", "weight", "bias", "stride", "padding",
                       "output_padding", "groups", "dilation"),
        {"stride": 1, "padding": 0, "output_padding": 0, "groups": 1,
         "dilation": 1})
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    (oph, opw), (dh, dw) = _pair(out_pad), _pair(dilation)
    if w.shape[2] != sh or dh != 1 or oph or x.hdim != 2:
        raise NotImplementedError(
            "conv_transpose2d on row slabs needs kernel rows == stride, no "
            "dilation or output padding along H")
    H = x.bounds[-1]
    h_out = H * sh - 2 * ph
    bounds = [min(max(b * sh - ph, 0), h_out) for b in x.bounds]
    bounds[-1] = h_out
    parts = []
    for k, p in zip(x.ex.slabs, x.parts):
        y = F.conv_transpose2d(p, x.ex.on(w, p.device), x.ex.on(b, p.device),
                               (sh, sw), (0, pw), (0, opw), groups, (1, dw))
        lo = bounds[k] - (x.bounds[k] * sh - ph)
        parts.append(y.narrow(2, lo, bounds[k + 1] - bounds[k]))
    if any(b1 <= b0 for b0, b1 in zip(bounds, bounds[1:])):
        raise ValueError(f"a transposed conv of rows {x.bounds} leaves an "
                         "empty slab")
    return x.like(parts, bounds)


def _pad(func, args, kwargs):
    x, pad, mode, value = _bind(args, kwargs, ("input", "pad", "mode",
                                               "value"), {"mode": "constant"})
    pad = list(pad)
    i = 2 * (x.ndim - 1 - x.hdim)
    top, bot = (pad[i], pad[i + 1]) if len(pad) > i else (0, 0)
    if mode != "constant" or min(pad) < 0:
        raise NotImplementedError("pad on row slabs: constant, >= 0")
    if len(pad) > i:
        pad[i] = pad[i + 1] = 0
    n = x.ex.n
    parts = []
    for k, p in zip(x.ex.slabs, x.parts):
        pk = list(pad)
        if len(pad) > i:
            pk[i], pk[i + 1] = (top if k == 0 else 0,
                                bot if k == n - 1 else 0)
        parts.append(F.pad(p, pk, mode, value)
                     if any(pk) or x.ex.group is not None else p)
    bounds = [0] + [b + top for b in x.bounds[1:-1]] + [
        x.bounds[-1] + top + bot]
    return x.like(parts, bounds)


def _interpolate(func, args, kwargs):
    x, size, scale, mode = _bind(args, kwargs, ("input", "size",
                                                "scale_factor", "mode"),
                                 {"mode": "nearest"})
    sh = _pair(scale)[0] if scale is not None else None
    if (mode != "nearest" or size is not None or x.hdim != 2
            or float(sh) != int(sh)):
        raise NotImplementedError("interpolate on row slabs: nearest, an "
                                  "integer scale_factor")
    out = _map(func, args, kwargs)
    out.bounds = [b * int(sh) for b in x.bounds]
    return out


def _batch_norm(func, args, kwargs):
    training = _bind(args, kwargs, ("input", "running_mean", "running_var",
                                    "weight", "bias", "training"), {})[5]
    if training:
        raise NotImplementedError(
            "train-mode batch_norm on row slabs: nn/layers.py::BatchNorm "
            "takes its moments over every slab (BatchNorm._global)")
    return _map(func, args, kwargs)


# ---------------------------------------------------- dims and indexing
def _getitem(func, args, kwargs):
    x, idx = args
    idx = idx if isinstance(idx, tuple) else (idx,)
    if any(not isinstance(i, slice) and i is not Ellipsis for i in idx):
        raise NotImplementedError("row slabs index by slices only")
    if Ellipsis in idx:
        e = idx.index(Ellipsis)
        idx = idx[:e] + (slice(None),) * (x.ndim - len(idx) + 1) + idx[e + 1:]
    idx = idx + (slice(None),) * (x.ndim - len(idx))
    h = idx[x.hdim]
    step = h.step or 1
    if h.stop is not None or (h.start or 0) >= step or any(
            b % step for b in x.bounds):
        raise NotImplementedError(
            f"row slabs of rows {x.bounds} index their rows by {h}")
    out = _map(func, (x, idx), {})
    out.bounds = [b // step for b in x.bounds]
    return out


def _cat(func, args, kwargs):
    tensors, dim = _bind(args, kwargs, ("tensors", "dim"), {"dim": 0})
    ref = _slabs_in(tensors, [])[0]
    if len(_slabs_in(tensors, [])) != len(tensors):
        raise NotImplementedError("cat of row slabs and whole tensors")
    if _norm_dim(dim, ref.ndim) == ref.hdim:
        raise NotImplementedError("cat of row slabs along their rows")
    return _map(func, args, kwargs)


def _chunk(func, args, kwargs):
    """chunk / split (x, n or size, dim=0)."""
    x, _, dim = _bind(args, kwargs, ("input", "n", "dim"), {"dim": 0})
    if _norm_dim(dim, x.ndim) == x.hdim:
        raise NotImplementedError(f"{func.__name__} of row slabs along "
                                  "their rows")
    return _map(func, args, kwargs)


def _permute(func, args, kwargs):
    x = args[0]
    dims = args[1] if len(args) == 2 and isinstance(args[1], (tuple, list)) \
        else (args[1:] or kwargs["dims"])
    dims = [_norm_dim(d, x.ndim) for d in dims]
    return _map(func, args, kwargs, hdim_out=dims.index(x.hdim))


def _reshape(func, args, kwargs):
    x = args[0]
    shape = args[1] if len(args) == 2 and isinstance(args[1], (tuple, list)) \
        else args[1:]
    shape = list(shape)
    full = list(x.shape)
    if len(shape) <= x.hdim or shape[:x.hdim + 1] != full[:x.hdim + 1]:
        raise NotImplementedError(f"reshape of row slabs {tuple(full)} to "
                                  f"{tuple(shape)} moves their rows")
    parts = []
    for p in x.parts:
        s = list(shape)
        s[x.hdim] = p.shape[x.hdim]
        parts.append(getattr(p, func.__name__)(s))
    return x.like(parts)


def _flatten(func, args, kwargs):
    x, start, end = _bind(args, kwargs, ("input", "start_dim", "end_dim"),
                          {"start_dim": 0, "end_dim": -1})
    start, end = _norm_dim(start, x.ndim), _norm_dim(end, x.ndim)
    if start <= x.hdim <= end and start != end:
        raise NotImplementedError("flatten of row slabs across their rows")
    return _map(func, args, kwargs, hdim_out=x.hdim - (
        max(end - start, 0) if end < x.hdim else 0))


def _reduce(func, args, kwargs):
    """mean / sum / amax / amin: over other dims on each slab; over the
    rows, the slabs' partial results combined on the first device (sums in
    f32, the mean over the whole count) into one whole tensor."""
    name = func.__name__
    x, dims, keepdim = _bind(args, kwargs, ("input", "dim", "keepdim"),
                             {"keepdim": False})
    dims = (list(range(x.ndim)) if dims is None else
            [_norm_dim(d, x.ndim) for d in
             (dims if isinstance(dims, (tuple, list)) else [dims])])
    if x.hdim not in dims:
        return _map(func, args, kwargs, hdim_out=x.hdim if keepdim else
                    x.hdim - sum(d < x.hdim for d in dims))
    if name in ("mean", "sum"):
        acc = torch.float32 if x.dtype.is_floating_point else None
        total = x.sum_over([p.sum(dims, keepdim=True, dtype=acc)
                            for p in x.parts])
        if name == "mean":
            total = total / int(np.prod([x.shape[d] for d in dims]))
        out = total.to(x.dtype) if acc is not None else total
    elif name in ("amax", "amin"):
        red = getattr(torch, name)
        out = red(torch.cat(x.each_partial([red(p, dims, keepdim=True)
                                            for p in x.parts]), x.hdim),
                  dims, keepdim=True)
    else:
        raise NotImplementedError(f"{name} of row slabs over their rows")
    return out if keepdim else out.squeeze(dims)


def _softmax(func, args, kwargs):
    x, dim = _bind(args, kwargs, ("input", "dim"), {})
    if _norm_dim(dim, x.ndim) == x.hdim:
        raise NotImplementedError("softmax of row slabs along their rows")
    return _map(func, args, kwargs)


_HANDLERS = {
    "conv2d": _conv2d, "max_pool2d": _max_pool2d,
    "conv_transpose2d": _conv_transpose2d, "pad": _pad,
    "interpolate": _interpolate, "batch_norm": _batch_norm,
    "__getitem__": _getitem, "cat": _cat, "concat": _cat,
    "chunk": _chunk, "split": _chunk,
    "permute": _permute, "reshape": _reshape, "view": _reshape,
    "flatten": _flatten, "mean": _reduce, "sum": _reduce, "amax": _reduce,
    "amin": _reduce, "softmax": _softmax,
}


# ------------------------------------------------------------- layer 0
BLUR_HALO = 12   # the USM's 25-tap radius (nn/enhance.py::gaussian_kernel_25)


def _resize_rows(x, out=256):
    """The (B, out, out, 3) torch-convention bilinear resize of NHWC row
    slabs on the first device, bit-equal to `torch_bilinear_resize` of the
    whole image. Each output row reads source rows lo and lo + 1; runs of
    output rows [i0, i1) with i0 a multiple of 8 start on source row i0 *
    H / out, an integer (H is a multiple of 32), so the same kernel, told
    the whole image's scale, computes them from just those rows, on the
    device that holds the first. Below `out` rows the resize upsamples, a
    band would read the row above its first, and the raw image (3
    channels, under `out` rows) is joined on the first device instead; so
    is a bf16 image, whose resize is JAX's two matrices."""
    from ..nn.enhance import torch_bilinear_resize
    H = x.bounds[-1]
    dev0 = x.ex.devices[0]
    scale = np.float32(H) / np.float32(out)
    exact = np.float32(1.0 / (out / H)) == scale
    if H < out or x.dtype != torch.float32 or not exact:
        return torch_bilinear_resize(x.join(dev0), out, out)
    src = np.maximum(scale * (np.arange(out, dtype=np.float32)
                              + np.float32(0.5)) - np.float32(0.5), 0)
    lo = np.floor(src).astype(np.int64)
    # each 8-row run of output rows goes to the slab holding its first row;
    # the owners rise with the rows, so a slab owns one band [i0, i1) of
    # output rows, which reads its source rows [r0, r1)
    owner = [int(np.searchsorted(x.bounds, int(8 * g * scale), "right")) - 1
             for g in range(out // 8)]
    bands = {}
    for g, k in enumerate(owner):
        bands.setdefault(k, [8 * g, 8 * g + 8])[1] = 8 * g + 8
    if len(bands) != x.ex.n:
        raise ValueError(f"{x.ex.n} slabs of {H} rows: a slab owns no band "
                         f"of the {out}-row resize")
    need = [(int(i0 * scale), min(int(lo[i1 - 1]) + 2, H))
            for i0, i1 in (bands[k] for k in range(x.ex.n))]
    pieces = []
    for k, band in zip(x.ex.slabs, x.fetch(need)):
        i0, i1 = bands[k]
        y = torch._C._nn.upsample_bilinear2d(
            band.contiguous().permute(0, 3, 1, 2), [i1 - i0, out], False,
            out / H, None)
        pieces.append(y.permute(0, 2, 3, 1))
    if x.ex.group is not None:
        return _placed(pieces[0], x.ex.slabs[0],
                       [i1 - i0 for i0, i1 in bands.values()], 1, x.ex.group)
    return torch.cat([p.to(dev0, non_blocking=True) for p in pieces], 1)


def _lowlight(mod, x, dedark_A=None, IcA=None):
    """Layer 0 on NHWC row slabs: its 15 parameters from the joined 256x256
    resize on the first device (the same for every slab), then the enhance
    kernel (or 'reference''s point chain and usm kernel) on each slab
    extended by BLUR_HALO rows of raw input from its neighbours, which the
    kernel's reflection reaches only at the image's true top and bottom;
    the halo rows cropped after (their outputs take no gradient; the
    features' gradient is the sum over the slabs). The priors: dedark_A
    (B, 3) whole on every slab, IcA (B, H, W, 1) cut with each slab's
    extended rows; the defaults where None, made per slab."""
    from ..nn.enhance import (DEFAULT_A, DEFAULT_ICA, apply_point_filters,
                              regress_filter_params)
    from ..ops import enhance_kernel as K
    small = _resize_rows(x).permute(0, 3, 1, 2)
    features = mod.extractor(small.to(mod.extractor.fc1.weight.dtype))
    b, H, W, _ = x.shape
    need = [(max(x.bounds[k] - BLUR_HALO, 0),
             min(x.bounds[k + 1] + BLUR_HALO, H)) for k in range(x.ex.n)]
    parts = []
    for k, dev, ext in zip(x.ex.slabs, x.ex.devices, x.fetch(need)):
        a0, a1 = x.bounds[k], x.bounds[k + 1]
        e0, e1 = need[k]
        feats = _alike(features, x.ex).to(dev, non_blocking=True)
        A = (torch.full((b, 3), DEFAULT_A, dtype=ext.dtype, device=dev)
             if dedark_A is None else dedark_A.to(dev, non_blocking=True))
        ica = (torch.full((b, e1 - e0, W, 1), DEFAULT_ICA, dtype=ext.dtype,
                          device=dev) if IcA is None else
               IcA[:, e0:e1].to(dev, non_blocking=True).contiguous())
        if mod.contrast_mode == "channel":
            y = K.fused_enhance(ext, feats, A, ica)
        else:
            params = regress_filter_params(feats)
            y = K.usm(apply_point_filters(ext, params, A, ica,
                                          mod.contrast_mode), params["usm"])
        parts.append(y.narrow(1, a0 - e0, a1 - a0))
    return x.like(parts)


# ---------------------------------------------------------- the executor
def _joined_types():
    from ..nn.heads import RTDETRDecoder
    from ..nn.transformer import AIFI, TransformerBlock
    return (AIFI, TransformerBlock, RTDETRDecoder)


JOINED = "AIFI, TransformerBlock (C3TR), RTDETRDecoder"


def _join_tree(obj):
    if isinstance(obj, RowSlabs):
        return obj.join()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_join_tree(o) for o in obj)
    return obj


class _Joined:
    """Forward hooks that run a module on its inputs joined by rows on the
    first device and split a map it returns at its input's rows;
    `joined_hooks` puts them on every such module of a model for a
    block."""

    def __init__(self):
        self.stack = []

    def pre(self, mod, args):
        s = _slabs_in(list(args), [])
        self.stack.append(s[0] if s else None)
        return _join_tree(tuple(args))

    def post(self, mod, args, out):
        ref = self.stack.pop()
        if (ref is None or not torch.is_tensor(out) or out.dim() != ref.ndim
                or out.shape[ref.hdim] != ref.bounds[-1]):
            return out
        b = ref.bounds
        out = _alike(out, ref.ex)
        return ref.like([out.narrow(ref.hdim, b[k], b[k + 1] - b[k]).to(
            dev, non_blocking=True) for k, dev in zip(ref.ex.slabs,
                                                      ref.ex.devices)])


# the models whose joined modules have their hooks on
_ACTIVE: "weakref.WeakSet" = weakref.WeakSet()


@contextlib.contextmanager
def joined_hooks(model):
    """A block within which the model's attention modules (`JOINED`) run
    joined on row slabs: `_Joined`'s hooks on each. A block inside another
    on the same model keeps the outer one's (the trainer holds them over
    the step's backward, where a remat recompute runs the modules
    again)."""
    if model in _ACTIVE:
        yield
        return
    joined, hooks = _Joined(), []
    _ACTIVE.add(model)
    try:
        for m in model.modules():
            if isinstance(m, _joined_types()):
                hooks.append(m.register_forward_pre_hook(joined.pre))
                hooks.append(m.register_forward_hook(joined.post))
        yield
    finally:
        _ACTIVE.discard(model)
        for hk in hooks:
            hk.remove()


# per model: {device: (replica, state signature)}
_REPLICAS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _signature(model):
    return tuple((k, v.data_ptr(), v._version)
                 for k, v in model.state_dict().items())


def replicas(model, devices):
    """The model on each distinct device of `devices`: itself on its own
    device, else a copy made once and kept for the model (its weights
    copied again when the model's state has changed)."""
    own = next(model.parameters()).device
    cache = _REPLICAS.setdefault(model, {})
    sig = None
    out = {}
    for dev in dict.fromkeys(devices):
        if dev == own:
            out[dev] = model
            continue
        sig = sig or _signature(model)
        hit = cache.get(dev)
        if hit is None:
            hit = cache[dev] = [copy.deepcopy(model).to(dev), sig]
        elif hit[1] != sig:
            hit[0].load_state_dict(model.state_dict())
            hit[1] = sig
        out[dev] = hit[0]
    return out


def row_devices(mesh, axis):
    """The devices along `axis` of a local mesh (the first of each other
    axis: the rows are not split over them)."""
    if not isinstance(mesh, Mesh) or not mesh.devices or mesh.spans_ranks:
        raise TypeError("spatial_infer takes a mesh over this process's "
                        "devices: make_mesh(devices=[...])")
    axis = axis if axis is not None else mesh.axis_names[0]
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no '{axis}'")
    grid = np.empty(len(mesh.devices), object)
    grid[:] = list(mesh.devices)
    grid = grid.reshape(mesh.shape)
    a = mesh.axis_names.index(axis)
    return list(np.moveaxis(grid, a, 0).reshape(grid.shape[a], -1)[:, 0])


def row_slabs(img, devices, copies=None):
    """An NHWC image as equal row slabs, slab k on devices[k]; `copies`
    the weights' copies of `Executor` (none where every device is the
    model's)."""
    img = torch.as_tensor(img)
    n = len(devices)
    step = img.shape[1] // n
    if step * n != img.shape[1]:
        raise ValueError(f"{img.shape[1]} rows do not split into {n} slabs")
    return RowSlabs([img[:, k * step:(k + 1) * step].to(dev, non_blocking=True)
                     for k, dev in enumerate(devices)],
                    [k * step for k in range(n + 1)], 1,
                    Executor(list(devices), copies or {}))


def rank_slab(img, mesh):
    """This rank's rows of an NHWC image (every rank holds the whole) as
    its one slab of a mesh whose 'spatial' axis runs over ranks."""
    img = torch.as_tensor(img)
    n, k = mesh.spatial, mesh.spatial_index
    step = img.shape[1] // n
    if step * n != img.shape[1]:
        raise ValueError(f"{img.shape[1]} rows do not split into {n} slabs")
    return RowSlabs([img[:, k * step:(k + 1) * step].to(mesh.device)],
                    [j * step for j in range(n + 1)], 1,
                    Executor([mesh.device], {}, [k], n, mesh.spatial_group))


@torch.inference_mode()
def spatial_infer(model, img, mesh=None, axis=None):
    """Eval-mode inference with the image's rows sharded over the mesh.

    model: a DetectionModel. img: (B, H, W, 3) in [0, 1], a tensor or an
    array; H must divide 32 * the axis's size (use spatial_pad_to and a
    letterbox fill). mesh: a local mesh (default: every CUDA device of the
    process on one 'spatial' axis); axis: the axis the rows split over
    (default its first). Returns what `model.eval_outputs` returns for the
    same image on one device ((boxes_xywh, scores) for detect), on the
    mesh's first device.

    On a mesh whose 'spatial' axis runs over ranks (JAX's spatial_infer
    over every process's devices) every rank of a spatial group passes the
    same image and gets the joined outputs on its own device, as JAX's
    replicated output; the model is on that device."""
    if isinstance(mesh, Mesh) and mesh.spans_ranks:
        check_rows(torch.as_tensor(img).shape[1], mesh.spatial)
        h, w = img.shape[1], img.shape[2]
        mode = model.training
        try:
            model.eval()
            with joined_hooks(model):
                raw = _join_tree(model(rank_slab(img, mesh)))
            return model.decode(raw, (h, w))
        finally:
            model.train(mode)
    if mesh is None:
        mesh = make_mesh(devices=[f"cuda:{i}" for i in
                                  range(torch.cuda.device_count())],
                         axes=("spatial",))
    devices = row_devices(mesh, axis)
    img = torch.as_tensor(img)
    h = img.shape[1]
    check_rows(h, len(devices))
    reps = replicas(model, devices)
    first = reps[devices[0]]
    copies = {}
    for dev, rep in reps.items():
        if rep is not first:
            for (_, t0), (_, t) in zip(
                    [*first.named_parameters(), *first.named_buffers()],
                    [*rep.named_parameters(), *rep.named_buffers()]):
                copies[(id(t0), dev)] = t
    x = row_slabs(img, devices, copies)
    modes = {r: r.training for r in reps.values()}
    try:
        for r in reps.values():
            r.eval()
        with joined_hooks(first):
            raw = _join_tree(first(x))
        return first.decode(raw, (h, img.shape[2]))
    finally:
        for r, mode in modes.items():
            r.train(mode)


def check_rows(h, n):
    if h % (32 * n):
        raise ValueError(f"H={h} must divide 32 * {n} devices (use "
                         "spatial_pad_to)")


def spatial_train(model, inputs, mesh, run=None):
    """The train forward of data x spatial training on one rank, with
    autograd on (see the module docstring): the image's rows as slabs over
    the rank's spatial devices (`mesh.devices`, in order; one may repeat;
    or a list of devices), or, on a mesh whose 'spatial' axis runs over
    ranks, this rank's slab.

    model: a DetectionModel in the mode the caller set, on the first
    device. inputs: (img (B, H, W, 3) in [0, 1] on that device, the whole
    image (every rank of a spatial group holds the same), H a multiple of
    32 * the spatial size; then layer 0's priors dedark_A and IcA, whole,
    or None). run: what calls the model on (slabs, *priors) (default the
    model itself; amp's `torch.func.functional_call` on the bf16 casts).
    Returns the head's raw outputs, joined on the first device (on every
    rank)."""
    img = inputs[0]
    if isinstance(mesh, Mesh) and mesh.spans_ranks:
        check_rows(img.shape[1], mesh.spatial)
        x = rank_slab(img, mesh)
    else:
        devices = list(mesh.devices if isinstance(mesh, Mesh) else mesh)
        check_rows(img.shape[1], len(devices))
        x = row_slabs(img, devices)
    with joined_hooks(model):
        return _join_tree((run or model)(x, *inputs[1:]))
