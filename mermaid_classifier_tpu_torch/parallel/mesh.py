"""Device-mesh construction for the extraction, serving and training paths.

Port of ``mermaid_classifier_tpu/parallel/mesh.py``. The layout policy is
the JAX one: a 2-D ``(data, model)`` mesh. The data axis carries the batch
dimension, the model axis shards the MLP head's hidden dimension
(``sharded_train.py``), and the extraction and serve paths shard their
batch over both axes flattened.

JAX builds one mesh over every chip from a single controller. The port is
SPMD instead: one process per device (``torchrun --nproc-per-node N`` starts
them), joined by ``torch.distributed`` into a ``DeviceMesh`` whose dims are
named ``("data", "model")``. Every rank passes the identical global inputs
and gets the identical global result, so the call signatures of the JAX
functions carry over unchanged. A CUDA mesh runs over NCCL, a CPU mesh over
gloo; the CPU is taken only when the caller asks for it (``device="cpu"``),
and a CUDA mesh without a card or without NCCL raises.

Rank ``r`` of an ``N``-rank mesh sits at ``(r // model, r % model)``: the
model dim is the inner, contiguous dim of the rank grid, and the flattened
batch block of rank ``r`` is block ``r``, as JAX's ``P(("data", "model"))``
lays it out.
"""

from __future__ import annotations

import copy
import os
from contextlib import contextmanager
from dataclasses import dataclass

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# all_gather_into_tensor was renamed; take whichever this torch has.
_all_gather_single = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)


@dataclass(frozen=True)
class MeshSpec:
    """How many devices along each logical axis."""

    data: int
    model: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model


def _largest_pow2_divisor(n: int, cap: int) -> int:
    d = 1
    while d * 2 <= cap and n % (d * 2) == 0:
        d *= 2
    return d


def default_mesh_spec(n_devices: int, model_parallel: int | None = None) -> MeshSpec:
    """Pick a (data, model) factorization of ``n_devices``.

    The head's widest layer is 4096x500; model parallelism beyond a few-way
    split is all collective and no compute, so default to model<=2 and give
    everything else to the batch axis.
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if model_parallel is None:
        model_parallel = _largest_pow2_divisor(n_devices, cap=2)
    if n_devices % model_parallel != 0:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide n_devices={n_devices}"
        )
    return MeshSpec(data=n_devices // model_parallel, model=model_parallel)


class Mesh:
    """This process's view of the ``(data, model)`` mesh: the
    ``DeviceMesh``, the device this rank drives, its position, and the
    process groups of its data and model rows."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, device_mesh, device: torch.device) -> None:
        self.device_mesh = device_mesh
        self.device = torch.device(device)
        data, model = (int(s) for s in device_mesh.mesh.shape)
        self.spec = MeshSpec(data=data, model=model)
        self.data_group = device_mesh.get_group(DATA_AXIS)
        self.model_group = device_mesh.get_group(MODEL_AXIS)
        self.data_rank = int(device_mesh.get_local_rank(DATA_AXIS))
        self.model_rank = int(device_mesh.get_local_rank(MODEL_AXIS))
        # The whole mesh: it covers the world (make_mesh checks).
        self.group = dist.group.WORLD

    @property
    def size(self) -> int:
        """The number of devices (ranks) in the mesh."""
        return self.spec.n_devices

    @property
    def shape(self) -> tuple[int, int]:
        return (self.spec.data, self.spec.model)

    @property
    def rank(self) -> int:
        """The flattened position ``data_rank * model + model_rank``: the
        batch block this rank holds on the extraction and serve paths."""
        return self.data_rank * self.spec.model + self.model_rank

    def check_device(self, device) -> None:
        """Raise unless ``device`` is the device this rank drives."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device != self.device:
            raise ValueError(
                f"device {device} is not this rank's mesh device {self.device}"
            )

    def all_gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's ``local`` rows stacked in rank order: the global
        tensor of a batch sharded over the flattened mesh (on the ``meta``
        device, its shape alone)."""
        local = local.contiguous()
        out = torch.empty((self.size * local.shape[0], *local.shape[1:]),
                          dtype=local.dtype, device=local.device)
        if out.device.type != "meta":
            _all_gather_single(out, local, group=self.group)
        return out

    def on_meta(self) -> "Mesh":
        """A view of this mesh on the ``meta`` device, for the preflight:
        the same ranks and groups, tensors with shapes and no data, and
        collectives that only shape their outputs."""
        view = copy.copy(self)
        view.device = torch.device("meta")
        return view

    def __repr__(self) -> str:
        return (f"Mesh(data={self.spec.data}, model={self.spec.model},"
                f" rank={self.rank}, device={self.device})")


def all_reduce_flat(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Sum ``tensors`` over ``group`` with one all-reduce of their
    concatenation; views of the summed buffer, shaped as the inputs (on the
    ``meta`` device, the shapes alone)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if flat.device.type != "meta":
        dist.all_reduce(flat, group=group)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view_as(t))
        start += t.numel()
    return out


def _env_int(name: str, default: int | None = None) -> int | None:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def _backend_for(device: str) -> str:
    device_type = torch.device(device).type
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA mesh was requested but torch.cuda.is_available() is"
                " False; pass device='cpu' for a gloo mesh on the CPU"
            )
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs NCCL, which this torch lacks")
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"mesh device must be cuda or cpu, got {device!r}")


# The card ``initialize_distributed`` bound this process's group to, with
# that group: a mesh over the same group drives the same card.
_bound: dict = {}


def _local_device(device: str, local_device_ids: list[int] | None = None) -> torch.device:
    """The device this rank drives: on a card the first of
    ``local_device_ids``, else the card ``initialize_distributed`` bound
    the running group to, else ``cuda:LOCAL_RANK``; the CPU otherwise."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if local_device_ids:
        return torch.device("cuda", local_device_ids[0])
    if dist.is_initialized() and _bound.get("group") is dist.group.WORLD:
        return _bound["device"]
    return torch.device("cuda", _env_int("LOCAL_RANK", 0))


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
    *,
    device: str = "cuda",
) -> None:
    """Join this process into the process group the mesh runs on
    (``torch.distributed.init_process_group``): NCCL for ``device="cuda"``,
    gloo for ``device="cpu"``.

    Missing arguments come from the variables ``torchrun`` sets:
    ``MASTER_ADDR``:``MASTER_PORT`` (the coordinator, ``host:port``),
    ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` (the card this process
    drives, unless ``local_device_ids`` names it). A second call is a
    no-op. At world size 1 with no coordinator the group gets its own
    in-process store, so one process needs no port.
    """
    if dist.is_initialized():
        return
    backend = _backend_for(device)
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE", 1)
    rank = process_id if process_id is not None else _env_int("RANK", 0)
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    local = _local_device(device, local_device_ids)
    if backend == "nccl":
        torch.cuda.set_device(local)
    if coordinator_address is None:
        if world != 1:
            raise ValueError(
                f"{world} processes need a coordinator address (or"
                " MASTER_ADDR / MASTER_PORT, as torchrun sets them)"
            )
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                rank=rank, world_size=world)
    _bound.update(group=dist.group.WORLD, device=local)


def _build(spec: MeshSpec, device: str, local_device_ids=None) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh

    local = _local_device(device, local_device_ids)
    if local.type == "cuda":
        torch.cuda.set_device(local)
    device_mesh = init_device_mesh(local.type, (spec.data, spec.model),
                                   mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(device_mesh, local)


def _check_group(device: str) -> int:
    """The world size of the initialized group, after checking that its
    backend is the one ``device`` asks for."""
    backend = _backend_for(device)
    have = dist.get_backend()
    if have != backend:
        raise RuntimeError(
            f"a {torch.device(device).type} mesh runs over {backend}, but the"
            f" process group runs {have}"
        )
    return dist.get_world_size()


def make_mesh(
    n_devices: int | None = None,
    *,
    model_parallel: int | None = None,
    device: str = "cuda",
) -> Mesh:
    """Build the ``(data, model)`` mesh over every rank of the process
    group (initialized from the environment first if it is not yet), one
    device per rank. ``n_devices`` must equal the world size: the port
    starts one process per device, and a process outside the mesh would
    miss its collectives."""
    initialize_distributed(device=device)
    world = _check_group(device)
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(
            f"requested {n_devices} devices but the process group has {world}"
            f" ranks; start one process per device (torchrun --nproc-per-node"
            f" {n_devices})"
        )
    return _build(default_mesh_spec(n_devices, model_parallel), device)


def make_multihost_mesh(
    model_parallel: int | None = None, *, device: str = "cuda"
) -> Mesh:
    """Build the ``(data, model)`` mesh over every process of every host.

    Needs ``initialize_distributed`` first. The model axis stays inside a
    host (its collectives run every layer), the data axis may span hosts
    (its gradients sync once per step): ``model_parallel`` must divide the
    per-host rank count ``LOCAL_WORLD_SIZE``, and since the model dim is
    the inner, contiguous dim of the rank grid and ``torchrun`` numbers a
    host's ranks contiguously, each model group lies on one host."""
    world = _check_group(device)
    n_local = _env_int("LOCAL_WORLD_SIZE", world)
    if world % n_local:
        raise ValueError(
            f"LOCAL_WORLD_SIZE={n_local} does not divide the world size {world}"
        )
    if world == n_local:
        return make_mesh(model_parallel=model_parallel, device=device)
    if model_parallel is None:
        model_parallel = _largest_pow2_divisor(n_local, cap=2)
    if n_local % model_parallel != 0:
        raise ValueError(
            f"model_parallel={model_parallel} must divide the per-host"
            f" device count {n_local} (the model axis cannot cross hosts)"
        )
    return _build(MeshSpec(data=world // model_parallel, model=model_parallel),
                  device)


@contextmanager
def cli_mesh(n_devices: int | None, *, device: str, command: str):
    """The mesh of a CLI's ``--mesh-devices N`` (None without it): one
    process per device, as ``torchrun --nproc-per-node N -m <command>``
    starts them. Raises, naming that command, when the world size is not
    ``N``; ends the process group on exit if it started it."""
    if not n_devices:
        yield None
        return
    world = _env_int("WORLD_SIZE", 1)
    if world != n_devices:
        raise SystemExit(
            f"--mesh-devices {n_devices} runs one process per device; start it"
            f" as: torchrun --nproc-per-node {n_devices} -m {command}"
            f" --mesh-devices {n_devices} ... (this process group's WORLD_SIZE"
            f" is {world})"
        )
    started = not dist.is_initialized()
    try:
        yield make_mesh(n_devices, device=device)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
