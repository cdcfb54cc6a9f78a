"""The data axis of a device mesh over a torch.distributed group (JAX
parallel/mesh.py).

JAX's trainer jits one global step over a mesh: the parameters are
replicated, the batch is sharded over the 'data' axis, and GSPMD computes
every reduction over the whole batch (BN's moments, the loss's normalisers,
the gradient). The port runs one process a device, as JAX's multi-process
run does, and computes the same function by hand: `nn/layers.py::BatchNorm`
all-reduces its per-channel sums, each loss all-reduces its normalisers
(`global_sum`), and `BaseTrainer.step` sums the gradients in one flat
bucket. Stock DistributedDataParallel and SyncBatchNorm are not used: they
keep per-rank statistics and normalisers and average the gradients, which
is another function.

    device = init_from_env()                  # torchrun's variables
    mesh = make_mesh()                        # shape (world,), axes ('data',)
    dev = shard_batch(mesh, batch)            # this rank's rows, on its device
    replicate(mesh, model.state_dict())       # rank 0's values everywhere

Launch: `python -m torch.distributed.run --nproc_per_node N -m
dedark_yolo_tpu_torch train ... mesh_shape=[N]`. At world size 1 there is
no group and no collective runs, so a mesh of one rank gives the numbers of
no mesh bit for bit.

A mesh over this process's own devices (`make_mesh(devices=[...])`, JAX
`make_mesh(devices=...)`) has no group: row-sharded inference
(`parallel/spatial.py`) splits one image's rows over its 'spatial' axis,
and `InferenceServer(mesh=)` and the validators a batch over its devices.
A device may repeat (`["cuda:0"] * 4`, `["cpu"] * 2`), the counterpart of
the virtual host devices JAX's tests run on: one card then holds every
shard.

Data x spatial training (JAX `shard_batch`'s P(data, spatial) image
leaves): `make_mesh(shape=(dp, sp), axes=("data", "spatial"))` takes one
of two layouts.
  - Inside a group of dp ranks each rank has its own sp devices
    (`devices=`, else the cards cuda:LOCAL_RANK*sp + k); at world size 1,
    shape (1, sp) is a local mesh. The rank's batch goes to its first
    device, where the loss runs; the trainer runs the graph on row slabs
    over the rank's devices (`parallel/spatial.py::spatial_train`), so the
    halo exchanges stay inside the process and only the data axis crosses
    ranks.
  - Inside a group of dp * sp ranks, one device a rank (JAX's
    multi-process mesh: `devices[:n]` reshaped to (dp, sp)), rank r sits at
    data index r // sp and spatial index r % sp. The ranks r // sp == k
    form data coordinate k's spatial group, the ranks r % sp == j spatial
    index j's data group; both kinds are made with `dist.new_group` in the
    same order on every rank and kept (`Mesh.spatial_group`,
    `Mesh.data_group`). Each rank holds its own row slab, and the slabs'
    halos, joins and reductions are collectives over the spatial group
    (`parallel/spatial.py`).

JAX's `batch_sharding` and `replicated` name GSPMD shardings, which mean
nothing without GSPMD; they are left out.

`GROUP_TIMEOUT` is the group's collective timeout: rank 0 validates alone
between epochs while the other ranks wait in the fitness broadcast, so it
must outlast the longest val (an hour covers COCO-sized val sets at 640).
Gloo on CUDA tensors runs only all_reduce and broadcast; Python objects
(`gather_objects`, `broadcast_object`) go through a gloo group on the CPU.
"""

from __future__ import annotations

import datetime
import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

GROUP_TIMEOUT = datetime.timedelta(hours=1)
ENV_KEYS = ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

# the device init_from_env gave this rank, and the gloo group for objects
_STATE: dict = {"device": None, "cpu_group": None, "subgroups": {},
                "timeout": GROUP_TIMEOUT}


@dataclass
class Mesh:
    """One rank's view of the mesh: `group` is the process group (None at
    world size 1), `device` the device this rank drives. A local mesh
    (`devices`, in the mesh's order) has no group; a data x spatial group
    mesh holds the rank's own spatial devices. `device` is then the
    first of `devices`."""
    group: object
    rank: int
    world: int
    device: torch.device
    axis_names: tuple = ("data",)
    shape: tuple = (1,)
    cpu_group: object = None
    devices: tuple = ()
    # a 'spatial' axis across ranks: this rank's spatial group (the slabs'
    # collectives), its data group (None at dp 1) and its spatial index
    spatial_group: object = None
    data_group: object = None
    spatial_index: int = 0

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def size(self) -> int:
        """The number of devices of the mesh (JAX `mesh.devices.size`)."""
        return self.world * max(len(self.devices), 1)

    @property
    def spatial(self) -> int:
        """The size of the 'spatial' axis (1 without one)."""
        return dict(zip(self.axis_names, self.shape)).get("spatial", 1)

    @property
    def spans_ranks(self) -> bool:
        """Whether the 'spatial' axis runs over ranks (one slab a rank)."""
        return self.spatial_group is not None

    @property
    def data_index(self) -> int:
        """This rank's coordinate on the data axis (its loader shard)."""
        return self.rank // self.spatial if self.spans_ranks else self.rank

    @property
    def data_size(self) -> int:
        """The number of data coordinates over the group's ranks."""
        return self.world // self.spatial if self.spans_ranks else self.world


def init_from_env(device=None, backend=None, timeout=GROUP_TIMEOUT):
    """Join the group torchrun's variables describe (WORLD_SIZE, RANK,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT); returns this rank's device. The
    counterpart of JAX's `jax.distributed.initialize` (JAX
    engine/trainer.py:380-389).

    `device`: None or 'cuda' means cuda:LOCAL_RANK, 'cpu' the CPU, an
    indexed device itself (two ranks on one card need 'cuda:0' and gloo).
    `backend`: None means nccl for CUDA, gloo for the CPU. Nothing falls
    back: missing variables, a missing device or a failed
    init_process_group raise."""
    env = os.environ
    if "WORLD_SIZE" not in env:
        raise RuntimeError("init_from_env needs WORLD_SIZE (launch with "
                           "python -m torch.distributed.run)")
    missing = [k for k in ENV_KEYS if k not in env]
    if missing:
        raise RuntimeError(f"WORLD_SIZE={env['WORLD_SIZE']} without "
                           f"{', '.join(missing)}")
    world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    local = int(env["LOCAL_RANK"])
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local)
        if not torch.cuda.is_available() or dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} has no device {dev} "
                               f"({torch.cuda.device_count()} CUDA devices)")
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"a rank drives a cuda device or the cpu, not {dev}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        world_size=world, rank=rank, timeout=timeout, **kw)
    _STATE.update(device=dev, cpu_group=None, subgroups={}, timeout=timeout)
    return dev


LOCAL_AXES = (("data",), ("spatial",), ("data", "spatial"))


def make_mesh(devices=None, shape=None, axes=("data",), device=None):
    """With axes ('data', 'spatial') and a shape (dp, sp) inside a group, or
    without `devices`: the data x spatial mesh (`spatial_mesh`). Else with
    `devices`: a mesh over those devices of this process (see
    `local_mesh`). Else the mesh over the current group (none: one rank on
    `device`, None meaning cuda) on the 'data' axis; `shape` defaults to
    (world,), its product the world size."""
    axes = tuple(axes or ("data",))
    grouped = dist.is_initialized() and dist.get_world_size() > 1
    if axes == ("data", "spatial") and shape is not None and (
            grouped or devices is None):
        return spatial_mesh(shape, devices, device)
    if devices is not None:
        return local_mesh(devices, shape, axes)
    if "spatial" in axes:
        raise ValueError(f"mesh axes {axes}: a spatial axis takes a shape "
                         "(dp, sp) over ('data', 'spatial'), or a mesh over "
                         "this process's devices: make_mesh(devices=[...])")
    if axes != ("data",):
        raise ValueError(f"mesh axes {axes}: the port has the ('data',) "
                         "axis only")
    world, rank, dev = _rank_device(device)
    shape = tuple(int(s) for s in (shape or (world,)))
    if len(shape) != len(axes) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} over axes {axes} does not "
                         f"match the world of {world} rank(s)")
    if world == 1:
        return Mesh(None, 0, 1, dev, axes, shape)
    return Mesh(dist.group.WORLD, rank, world, dev, axes, shape, _cpu_group())


def _rank_device(device):
    """(world, rank, this rank's device): in a group the device it joined
    with (or `device` where indexed), else one rank on `device` (None:
    cuda)."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        # an unindexed 'cuda' (the trainer's default) is the rank's own card
        dev = None if device is None else torch.device(device)
        own = _STATE["device"]
        if dev is None or (dev.type == "cuda" and dev.index is None):
            dev = own if own is not None and (
                dev is None or own.type == dev.type) else None
        if dev is None:
            raise RuntimeError(f"rank {rank} has no device: join the group "
                               "with init_from_env or pass an indexed "
                               "device")
        return world, rank, dev
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return 1, 0, dev


def _cpu_group():
    """The gloo group for Python objects: the world's own under gloo, else
    one made once (a collective: every rank is here)."""
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    if _STATE["cpu_group"] is None:
        _STATE["cpu_group"] = dist.new_group(backend="gloo",
                                             timeout=_STATE["timeout"])
    return _STATE["cpu_group"]


def spatial_mesh(shape, devices=None, device=None):
    """The data x spatial mesh (JAX `make_mesh(shape=(dp, sp), axes=(
    'data', 'spatial'))`, trainer.py:416-440) as this rank sees it. In a
    group of dp * sp ranks (sp > 1) the 'spatial' axis runs over ranks, one
    device a rank (`rank_spatial_mesh`). Else the 'data' axis is the dp
    ranks of the group (one process at world size 1, a local mesh) and the
    'spatial' axis this rank's own sp devices: `devices` (sp of them; one
    may repeat), else the cards cuda:LOCAL_RANK*sp + k for a cuda `device`
    without an index (None too), sp times an indexed one, or the CPU sp
    times. A host without those cards raises; nothing falls back."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} over ('data', 'spatial') "
                         "needs two sizes (dp, sp)")
    dp, sp = shape
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp != world:
        if dp * sp == world:
            return rank_spatial_mesh(shape, devices, device)
        raise ValueError(
            f"mesh {shape}: its {dp}-way data axis needs {dp} rank(s) "
            f"(python -m torch.distributed.run --nproc_per_node {dp}), or "
            f"{dp * sp} with one device each; this run has {world}")
    if devices is None:
        d = torch.device("cuda" if device is None else device)
        if d.type == "cuda" and d.index is None:
            local = int(os.environ.get("LOCAL_RANK", "0")) if world > 1 else 0
            devices = [f"cuda:{local * sp + k}" for k in range(sp)]
        else:
            devices = [d] * sp
    if len(devices) != sp:
        raise ValueError(f"mesh {shape}: a rank takes its {sp} spatial "
                         f"devices, not {len(devices)}")
    mesh = local_mesh(devices, (1, sp), ("data", "spatial"))
    if world == 1:
        return mesh
    own = _STATE["device"]
    if dist.get_backend() == "nccl" and own is not None \
            and own != mesh.device:
        raise RuntimeError(f"rank {dist.get_rank()} joined the group on "
                           f"{own} but its spatial devices start at "
                           f"{mesh.device}: init_from_env(device="
                           f"'{mesh.device}')")
    return Mesh(dist.group.WORLD, dist.get_rank(), world, mesh.device,
                ("data", "spatial"), shape, _cpu_group(), mesh.devices)


def rank_spatial_mesh(shape, devices=None, device=None):
    """The (dp, sp) data x spatial mesh over a group of dp * sp ranks, one
    device a rank, laid out as JAX lays `devices[:n]` out: rank r at data
    index r // sp and spatial index r % sp. The rank's device is the one it
    joined the group with (`devices` may name it, one device); the
    subgroups are made once a shape (collectives: every rank is here)."""
    dp, sp = shape
    world, rank, dev = _rank_device(device)
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != 1 or devs[0] != dev:
            raise ValueError(f"mesh {shape} over {world} ranks: each rank "
                             f"drives its own device ({dev}), not "
                             f"{[str(d) for d in devs]}")
    spatial_groups, data_groups = _subgroups(dp, sp)
    return Mesh(dist.group.WORLD, rank, world, dev, ("data", "spatial"),
                (dp, sp), _cpu_group(), (dev,),
                spatial_group=spatial_groups[rank // sp],
                data_group=data_groups[rank % sp] if dp > 1 else None,
                spatial_index=rank % sp)


def _subgroups(dp, sp):
    """Every data coordinate's spatial group (ranks k*sp .. k*sp + sp - 1)
    and every spatial index's data group (ranks j, j + sp, ...), made once
    a (dp, sp) in this order on every rank."""
    key = (dp, sp)
    if key not in _STATE["subgroups"]:
        new = lambda ranks: dist.new_group(ranks, timeout=_STATE["timeout"])
        spatial = [new(list(range(k * sp, (k + 1) * sp))) for k in range(dp)]
        data = ([new(list(range(j, dp * sp, sp))) for j in range(sp)]
                if dp > 1 else [])
        _STATE["subgroups"][key] = (spatial, data)
    return _STATE["subgroups"][key]


def local_mesh(devices, shape=None, axes=("data",)):
    """A mesh over devices this one process drives (JAX `make_mesh(
    devices=...)`): axes ('data',), ('spatial',) or ('data', 'spatial'),
    `shape` (default (len(devices),) on one axis) multiplying to the number
    of devices. A device may repeat. Every device is CUDA or every one the
    CPU; a CUDA device that this process does not have raises, and nothing
    moves to the CPU unless the list says 'cpu'. It has no group, also
    inside one (a rank's own devices: rank 0's per-epoch val)."""
    axes = tuple(axes)
    if axes not in LOCAL_AXES:
        raise ValueError(f"mesh axes {axes}: a local mesh takes "
                         f"{' or '.join(map(str, LOCAL_AXES))}")
    devs = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"no CUDA device is available for {d}; "
                                   "name 'cpu' devices to run on the CPU")
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            if d.index >= torch.cuda.device_count():
                raise RuntimeError(f"no device {d} ({torch.cuda.device_count()}"
                                   " CUDA devices)")
        elif d.type != "cpu":
            raise ValueError(f"a mesh device is cuda or cpu, not {d}")
        devs.append(d)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"mesh devices {[str(d) for d in devs]} mix CUDA "
                         "and the CPU")
    if shape is None:
        if len(axes) != 1:
            raise ValueError(f"mesh axes {axes} need a shape")
        shape = (len(devs),)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes) or math.prod(shape) != len(devs):
        raise ValueError(f"mesh shape {shape} over axes {axes} does not "
                         f"match {len(devs)} device(s)")
    return Mesh(None, 0, 1, devs[0], axes, shape, None, tuple(devs))


def mesh_group(mesh):
    """The group whose collectives a step runs: None without a mesh or at
    world size 1."""
    return mesh.group if mesh is not None and mesh.world > 1 else None


def upload(device, batch, keys=None):
    """The batch's arrays (`keys`, default all) as tensors on `device`; from
    the host through pinned memory, without waiting."""
    out = {}
    for k in (batch if keys is None else keys):
        t = torch.as_tensor(batch[k])
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def shard_batch(mesh, batch, keys=None):
    """This rank's rows on its device (its first under a 'spatial' axis,
    whose rows the trainer splits into slabs itself). Each rank's loader
    already holds its own rows (`data/loader.py`, JAX mesh.py:45-51: the
    global batch is the per-rank batch times the world), so this is the
    upload. A local mesh whose data axis spans several devices splits its
    batches itself (InferenceServer, the validators) and raises here."""
    _one_device(mesh, "shard_batch")
    return upload(mesh.device, batch, keys)


def _one_device(mesh, what):
    if len(mesh.devices) > mesh.spatial:
        raise ValueError(f"{what} takes a group mesh (one process a data "
                         "coordinate, its rows on its first device); a data "
                         "axis over this process's devices serves "
                         "(InferenceServer(mesh=)) and validates")


def _flat_collective(tensors, collective):
    """`collective` run in place on one flat buffer a dtype of `tensors`;
    returns each tensor's result, a view into its buffer, in order."""
    out = [None] * len(tensors)
    index = {}
    for i, t in enumerate(tensors):
        index.setdefault(t.dtype, []).append(i)
    for idx in index.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        collective(flat)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out


def replicate(mesh, tensors):
    """Rank 0's values in every rank's tensors (in place; one broadcast a
    dtype); returns `tensors`. A dict or a sequence of tensors on the
    rank's device."""
    _one_device(mesh, "replicate")
    group = mesh_group(mesh)
    if group is None:
        return tensors
    vals = list(tensors.values()) if isinstance(tensors, dict) else list(tensors)
    with torch.no_grad():
        for t, v in zip(vals, _flat_collective(
                vals, lambda f: dist.broadcast(f, 0, group=group))):
            t.copy_(v)
    return tensors


def all_reduce_sum(tensors, group):
    """The tensors summed over `group`, in one flat bucket a dtype (each
    rank gets the same sums); returns new tensors. None as group: the
    tensors themselves."""
    if group is None:
        return list(tensors)
    return _flat_collective(list(tensors),
                            lambda f: dist.all_reduce(f, group=group))


def global_sum(group, *values):
    """Detached sums over the group of the given scalars (tensors or
    numbers, on the first tensor's device), in one all-reduce; without a
    group the values as they are. The losses' normalisers: a reduction JAX
    takes over the global batch."""
    if group is None:
        return values if len(values) > 1 else values[0]
    ref = next(v for v in values if torch.is_tensor(v))
    flat = torch.stack([v.detach().to(torch.float32).reshape(())
                        if torch.is_tensor(v)
                        else ref.new_tensor(float(v), dtype=torch.float32)
                        for v in values])
    dist.all_reduce(flat, group=group)
    out = tuple(flat.unbind(0))
    return out if len(out) > 1 else out[0]


def barrier(mesh):
    """Every rank waits here for the others (an all-reduce on the rank's
    device, which every backend runs)."""
    group = mesh_group(mesh)
    if group is not None:
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=group)


def broadcast_object(mesh, obj):
    """Rank 0's `obj` on every rank (pickled, through the CPU)."""
    if mesh_group(mesh) is None:
        return obj
    box = [obj if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0, group=mesh.cpu_group)
    return box[0]


def gather_objects(mesh, obj):
    """Every rank's `obj` in rank order on rank 0, None on the others
    (pickled, through the CPU)."""
    if mesh_group(mesh) is None:
        return [obj]
    out = [None] * mesh.world if mesh.rank == 0 else None
    dist.gather_object(obj, out, dst=0, group=mesh.cpu_group)
    return out


def gather_in_order(mesh, records):
    """Every rank's (position, record) pairs on rank 0, its records sorted
    by position; None on the other ranks (a validator's per-image stats)."""
    parts = gather_objects(mesh, records)
    if parts is None:
        return None
    return [rec for _, rec in sorted((r for part in parts for r in part),
                                     key=lambda r: r[0])]


def rank_rows(n, mesh):
    """The rows [lo, hi) of an n-row batch that this rank runs: an even
    split when the world divides n, else all of them on rank 0 (JAX's
    validators shard a batch over the mesh only when it divides,
    validator.py:337-341)."""
    if mesh is None or mesh.world == 1:
        return 0, n
    if n % mesh.world == 0:
        per = n // mesh.world
        return mesh.rank * per, (mesh.rank + 1) * per
    return (0, n) if mesh.rank == 0 else (0, 0)
