"""The (dp, sp) device mesh, the sharding helpers and the rank launcher.

PyTorch twin of ``woft_tpu/parallel/mesh.py``. There the mesh is a
``jax.sharding.Mesh`` and XLA places every shard; here each rank is a
process with one explicit device, the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the initialised process
group with the dims ``("dp", "sp")``, and the collectives run on its
sub-groups: ``dp`` splits streams, targets and training rows, ``sp`` splits
one frame pair's correlation (``sharding.py``).

The collectives are ``all_reduce`` and ``broadcast`` only: ``gloo`` runs
both on CUDA tensors, not ``all_gather`` or ``reduce_scatter``, and two
``gloo`` ranks sharing one card are how a one-GPU machine runs the
two-rank paths (NCCL refuses two ranks on one GPU). A gather is then
``gather_by_sum``: each rank writes its rows into a zero-filled buffer
and one ``all_reduce(SUM)`` assembles them. Every collective of the
package goes through the three functions below.

``launch`` runs ``fn(rank, world, device, *args)`` on spawned ranks with a
backend and one device per rank that the caller names: the trainer's
``--dp`` (NCCL, ``cuda:r``), the tests (``gloo``, the CPU) and
``chip_smoke.py`` (``gloo``, both ranks on ``cuda:0``).
"""

import contextlib
import datetime
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

AXES = ("dp", "sp")


def make_mesh(n_devices=None, sp=1, device=None):
    """The (dp, sp) mesh over the ranks of the initialised process group:
    rank r sits at (r // sp, r % sp), dp = n_devices // sp. ``n_devices``
    (default: the world size) must be the world size; ``device`` is this
    rank's device, whose type is the mesh's (default 'cpu'). Raises
    ``ValueError`` when ``sp`` does not divide the ranks."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"the mesh spans every rank: {n} devices asked, "
                         f"{world} ranks")
    if sp < 1 or n % sp:
        raise ValueError(f"sp {sp} does not divide the {n} ranks")
    kind = "cpu" if device is None else torch.device(device).type
    return DeviceMesh(kind, torch.arange(n).reshape(n // sp, sp),
                      mesh_dim_names=AXES)


def mesh_shape(mesh):
    """``{"dp": dp, "sp": sp}``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _map(fn, tree):
    """``fn`` on every tensor of a nested dict / list / tuple; other leaves
    (a ``torch.Generator``, numbers) as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _share(x, axis, n, i):
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of a {tuple(x.shape)} tensor does not "
                         f"split into {n}")
    size = x.shape[axis] // n
    return x.narrow(axis, i * size, size)


def shard_batch(mesh, tree, spatial_axis=None):
    """This rank's share of every tensor of ``tree``: its ``dp`` slice of
    the leading dim and, for tensors of 4 or more dims whose
    ``spatial_axis`` splits evenly, its ``sp`` slice of that axis (the
    JAX function's placement, read from this rank's side). Views, not
    copies."""
    dp, sp = mesh.shape
    r_dp = mesh.get_local_rank("dp")
    r_sp = mesh.get_local_rank("sp")

    def share(x):
        x = _share(x, 0, dp, r_dp)
        if (spatial_axis is not None and x.dim() >= 4
                and x.shape[spatial_axis] % sp == 0):
            x = _share(x, spatial_axis, sp, r_sp)
        return x

    return _map(share, tree)


def replicate(mesh, module_or_tensors):
    """Every rank's copy made equal to rank 0's by one ``broadcast`` a
    tensor: a module's parameters and buffers in place, or each tensor of
    a nested dict / list / tuple in place (returned)."""
    if isinstance(module_or_tensors, torch.nn.Module):
        tensors = [*module_or_tensors.parameters(),
                   *module_or_tensors.buffers()]
    else:
        tensors = []
        _map(tensors.append, module_or_tensors)
    with torch.no_grad():
        for t in tensors:
            broadcast_(t, mesh)
    return module_or_tensors


# ---------------------------------------------------------------------------
# the package's collectives
# ---------------------------------------------------------------------------

def all_reduce_sum(t, mesh, axis=None):
    """In-place sum of ``t`` over the ranks of ``axis`` ('dp' or 'sp'), or
    over the whole mesh (None). Returns ``t``."""
    group = None if axis is None else mesh.get_group(axis)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def broadcast_(t, mesh):
    """Rank 0's ``t`` to every rank of the mesh, in place."""
    dist.broadcast(t, src=int(mesh.mesh.flatten()[0]))
    return t


def gather_by_sum(shape, parts, mesh, axis, device):
    """An all-gather from ``all_reduce`` alone: each rank of ``axis``
    writes its ``parts``, ``(index, tensor)`` pairs (index a tuple of
    slices; none at all on a rank that holds nothing), into a zero-filled
    float32 buffer of ``shape`` on ``device``, and one ``all_reduce(SUM)``
    gives every rank the whole; entries no rank writes stay 0. Under NCCL a
    real all-gather would move each rank's rows once instead of the whole
    buffer."""
    buf = torch.zeros(shape, dtype=torch.float32, device=device)
    for index, part in parts:
        buf[index] = part
    return all_reduce_sum(buf, mesh, axis)


# ---------------------------------------------------------------------------
# process groups and the launcher
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def process_group(backend, init_file, rank, world, timeout=60.0):
    """The default process group for the block: ``init_process_group``
    with a file store (``init_file``, on a file system every rank sees: no
    TCP port), the given backend, rank and world size, and ``timeout``
    seconds for its collectives; destroyed on the way out."""
    dist.init_process_group(
        backend, init_method=f"file://{os.path.abspath(init_file)}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank, fn, world, backend, devices, args, workdir, timeout):
    torch.set_num_threads(1)            # the ranks share the host's cores
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    with process_group(backend, os.path.join(workdir, "store"), rank, world,
                       timeout):
        result = fn(rank, world, device, *args)
    torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))


def launch(fn, world, backend, devices, args=(), timeout=60.0,
           join_timeout=None):
    """Run ``fn(rank, world, device, *args)`` on ``world`` spawned ranks.

    ``backend`` ('nccl' or 'gloo') and ``devices`` (one device a rank) are
    the caller's: nothing here picks either. ``fn`` is a module-level
    function (the ranks import it) and its result must pickle; each rank
    holds torch at one intra-op thread. The process group gets
    ``timeout`` seconds for its set-up and collectives; the ranks get
    ``join_timeout`` seconds in all (default 4 x ``timeout``), after which
    every rank still running is killed and ``TimeoutError`` raised. If a
    rank fails, the others are stopped and its error re-raised here with
    its traceback. Returns the ranks' results in rank order."""
    if len(devices) != world:
        raise ValueError(f"{world} ranks need {world} devices, got "
                         f"{len(devices)}")
    if join_timeout is None:
        join_timeout = 4 * timeout
    workdir = tempfile.mkdtemp(prefix="woft_ranks_")
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, backend, [str(d) for d in devices],
                          tuple(args), workdir, timeout),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + join_timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} still "
                                   f"running after {join_timeout} s")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(workdir, ignore_errors=True)
