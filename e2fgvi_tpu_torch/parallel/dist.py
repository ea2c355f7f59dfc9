"""Training across processes: environment discovery, torch.distributed
init, DistributedDataParallel wrapping.

Counterpart of e2fgvi_tpu/parallel/mesh.py (the reference's
train.py:29-35, core/trainer.py:70-81, core/dist.py). World discovery
(detect_world, coordinator_address) is the JAX package's, copied
(mesh.py:26-62), with torchrun's WORLD_SIZE / RANK after the E2FGVI_*
overrides. Processes meet over TCP at the coordinator address: NCCL on the
card, gloo when the CPU is asked for by name, or whatever
E2FGVI_DIST_BACKEND names (gloo for model ranks that share one card, which
NCCL refuses). The generator and the discriminator are each wrapped in
DistributedDataParallel over the ranks that hold the same parameters: all
of them where training is data parallel only, as the reference trains, and
a model index's data ranks where the JAX package's tensor parallelism
(`trainer.model_parallel`, parallel/tensor.py) splits the transformer.
"""

import os

import torch
import torch.distributed as tdist
from torch.nn.parallel import DistributedDataParallel


def detect_world():
    """(num_processes, process_id) from scheduler env vars: the E2FGVI_*
    overrides, torchrun, PMI, OpenMPI (reference core/dist.py:5-26)."""
    size = os.environ.get("E2FGVI_NUM_PROCESSES") or \
        os.environ.get("WORLD_SIZE") or \
        os.environ.get("PMI_SIZE") or \
        os.environ.get("OMPI_COMM_WORLD_SIZE") or "1"
    rank = os.environ.get("E2FGVI_PROCESS_ID") or \
        os.environ.get("RANK") or \
        os.environ.get("PMI_RANK") or \
        os.environ.get("OMPI_COMM_WORLD_RANK") or "0"
    return int(size), int(rank)


def coordinator_address(default_port=23455):
    """Coordinator host:port (reference get_master_ip, core/dist.py:41-47)."""
    if os.environ.get("E2FGVI_COORDINATOR"):
        return os.environ["E2FGVI_COORDINATOR"]
    if os.environ.get("AZ_BATCH_MASTER_NODE"):
        host = os.environ["AZ_BATCH_MASTER_NODE"].split(":")[0]
    elif os.environ.get("AZ_BATCHAI_MPI_MASTER_NODE"):
        host = os.environ["AZ_BATCHAI_MPI_MASTER_NODE"]
    else:
        host = "127.0.0.1"
    return f"{host}:{default_port}"


def local_device(device: torch.device, rank: int) -> torch.device:
    """The card of this process: LOCAL_RANK (torchrun) or rank modulo the
    cards on the host; the CPU stays the CPU."""
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
    return torch.device("cuda", local)


def initialize(device: torch.device):
    """Join the process group when the world has more than one process
    (a no-op for one). Returns (world size, rank)."""
    size, rank = detect_world()
    if size > 1 and not tdist.is_initialized():
        backend = os.environ.get("E2FGVI_DIST_BACKEND") or (
            "nccl" if device.type == "cuda" else "gloo")
        tdist.init_process_group(
            backend,
            init_method=f"tcp://{coordinator_address()}", world_size=size,
            rank=rank)
    return size, rank


def data_parallel(module, device: torch.device, grid=None):
    """module wrapped in DistributedDataParallel where a process group is
    up, else the module. With a tensor-parallel grid (parallel/tensor.py,
    model > 1) the gradients are averaged over the rank's data-parallel
    group, the ranks holding the same shard, and a grid of one data rank
    takes no wrapper. Buffers are not broadcast: the discriminator's
    spectral-norm vectors are replaced each call and are equal on every
    rank (the same weights, the same iteration)."""
    if not (tdist.is_available() and tdist.is_initialized()):
        return module
    group = None
    if grid is not None and grid.model > 1:
        if grid.data == 1:
            return module
        group = grid.dp_group
    ids = [device.index] if device.type == "cuda" else None
    return DistributedDataParallel(module, device_ids=ids,
                                   broadcast_buffers=False,
                                   process_group=group)
