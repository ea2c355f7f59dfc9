"""Tensor parallelism of the generator's transformer over a
('data', 'model') process grid.

Counterpart of e2fgvi_tpu/parallel/mesh.py:64-71 (make_mesh) and :89-112
(generator_param_sharding), and of `trainer.model_parallel`
(e2fgvi_tpu/train/trainer.py:45-47, 79-88):

- The grid. world = data x model processes; rank r sits at data index
  r // model and model index r % model, the layout of make_mesh's
  reshape(data, model), where the model ranks are adjacent. A
  tensor-parallel group holds the model ranks of one data index (they
  share a batch); a data-parallel group holds the data ranks of one model
  index (they hold the same shard, and DistributedDataParallel averages
  their gradients).
- The shard plan (shard_dim), generator_param_sharding through the port's
  parameter names (convert/from_jax.py): in each transformer block qkv's
  and fc1's weights and biases are split on their outputs, proj's and
  fc2's weights on their inputs; everything else, proj's and fc2's biases
  included, is replicated. qkv is split by heads: rank r of m holds rows
  s*512 + r*512/m ... s*512 + (r+1)*512/m for s in (q, k, v), so its rows
  reshape to (3, heads/m, hd) as the forward reads them. fc1's 1960
  channel-major outputs (c*49 + k) are split contiguously, 40/m whole
  channels of 49 taps a rank, so the fold and its counts stay per channel;
  fc2's inputs are split to match. (GSPMD splits the JAX package's
  kernel-major fc1 contiguously instead: the same numbers.)
- The Megatron pair (models/tfocal.py calls them): copy_to_model
  (identity forward, gradient all-reduced over the tensor-parallel group
  backward) where replicated activations enter a split GEMM, and
  reduce_from_model (all-reduce forward, identity backward) on the partial
  products of proj and fc2, whose biases are added once after it.
- The replicated parameters' gradients are averaged over the
  tensor-parallel group before each optimizer step
  (sync_replicated_grads). The ranks of a group compute them from the same
  inputs, so on the CPU they are equal already; on the card the backward's
  atomics make them differ in rounding, and the ranks' replicated weights
  (the discriminator's, feat_prop's) would part.

Every collective here is an all-reduce (a gather is an all-reduce of
zero-padded shards), so the path runs on gloo with CUDA tensors, which has
no CUDA all_gather, as well as on NCCL: two model ranks on one card must
use gloo, since NCCL refuses two ranks on one device.

m must divide the transformer's 4 heads and F3N's 40 hidden channels, so
m is 1, 2 or 4; the JAX package takes any m that divides its dims.
"""

from dataclasses import dataclass

import torch
import torch.distributed as tdist
import torch.nn as nn

HEADS = 4              # models/e2fgvi.NUM_HEADS
F3N_CHANNELS = 40      # F3N's hidden width 1960 = 40 channels x 49 taps

# when a list: each tensor-parallel all-reduce appends (kind, shape) to it,
# kind "forward" (reduce_from_model), "backward" (copy_to_model's
# gradient), "grads" (sync_replicated_grads) or "gather"; the tests compare
# the ranks' sequences
TRACE = None


def check_model_parallel(model_parallel) -> int:
    m = int(model_parallel)
    if m < 1 or HEADS % m or F3N_CHANNELS % m:
        raise ValueError(
            f"model_parallel {m} must divide the transformer's {HEADS} "
            f"heads and F3N's {F3N_CHANNELS} hidden channels (1, 2 or 4)")
    return m


@dataclass(frozen=True)
class Grid:
    """This process's place in the ('data', 'model') grid and its groups
    (None where model is 1: data parallel over the default group)."""
    data: int
    model: int
    rank: int
    tp_group: object = None
    dp_group: object = None

    @property
    def data_index(self):
        return self.rank // self.model

    @property
    def model_index(self):
        return self.rank % self.model


def make_grid(world: int, rank: int, model_parallel=1) -> Grid:
    """The grid of `world` processes with `model_parallel` model ranks.
    Every rank must call it (each new_group is collective over the world)."""
    m = check_model_parallel(model_parallel)
    if world % m:
        raise ValueError(f"{world} processes do not split into groups of "
                         f"model_parallel {m}")
    data = world // m
    if m == 1:
        return Grid(data, 1, rank)
    tp = dp = None
    for d in range(data):
        group = tdist.new_group([d * m + j for j in range(m)])
        if d == rank // m:
            tp = group
    for j in range(m):
        group = tdist.new_group([d * m + j for d in range(data)])
        if j == rank % m:
            dp = group
    return Grid(data, m, rank, tp, dp)


def _all_reduce(t, grid, kind):
    if TRACE is not None:
        TRACE.append((kind, tuple(t.shape)))
    tdist.all_reduce(t, group=grid.tp_group)
    return t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(memory_format=torch.contiguous_format),
                           ctx.grid, "backward"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        return _all_reduce(x.clone(memory_format=torch.contiguous_format),
                           grid, "forward")

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x, grid):
    """x as it is; its gradient summed over the tensor-parallel group."""
    return _CopyToModel.apply(x, grid)


def reduce_from_model(x, grid):
    """x summed over the tensor-parallel group; the gradient as it is."""
    return _ReduceFromModel.apply(x, grid)


# ---------------------------------------------------------------------------
# The shard plan
# ---------------------------------------------------------------------------

def shard_dim(name: str):
    """The dim of generator parameter `name` (the reference checkpoint's
    keys) split over 'model', or None where it is replicated."""
    if not name.startswith("transformer."):
        return None
    if ".attn.qkv." in name or ".mlp.conv1.0." in name:
        return 0
    if name.endswith((".attn.proj.weight", ".mlp.conv2.1.weight")):
        return 1
    return None


def _indices(name, full, m, r, device):
    """Rank r's indices along the split dim of a `full`-long dim."""
    if ".attn.qkv." in name:        # by heads within each of q, k, v
        part = full // 3
        n = part // m
        idx = [torch.arange(s * part + r * n, s * part + (r + 1) * n)
               for s in range(3)]
        return torch.cat(idx).to(device)
    n = full // m
    return torch.arange(r * n, (r + 1) * n, device=device)


def shard_tensor(name, full, m, r):
    """Rank r of m's shard of generator parameter `name` (or of a tensor of
    its shape, such as an Adam moment)."""
    d = shard_dim(name)
    if d is None or m == 1:
        return full
    return full.index_select(d, _indices(name, full.shape[d], m, r,
                                         full.device))


def unshard_tensor(name, shards):
    """The full tensor from the m ranks' shards, in model-rank order."""
    d = shard_dim(name)
    if d is None or len(shards) == 1:
        return shards[0]
    m = len(shards)
    shape = list(shards[0].shape)
    shape[d] *= m
    full = shards[0].new_empty(shape)
    for r, s in enumerate(shards):
        full.index_copy_(d, _indices(name, shape[d], m, r, s.device), s)
    return full


def shard_state_dict(sd, m, r):
    """A full reference-layout state dict to rank r of m's shard."""
    return {k: shard_tensor(k, v, m, r) for k, v in sd.items()}


def gather_state_dict(shards):
    """The full state dict from the m ranks' shard state dicts."""
    return {k: unshard_tensor(k, [s[k] for s in shards]) for k in shards[0]}


def gather_tensor(name, local, grid):
    """The full tensor from this rank's shard and its tensor-parallel
    group's, on every rank of the group: an all-reduce of the shards, each
    in its place among zeros (x + 0 = x, so it is exact)."""
    d = shard_dim(name)
    if d is None or grid.model == 1:
        return local
    shape = list(local.shape)
    shape[d] *= grid.model
    full = local.new_zeros(shape)
    full.index_copy_(d, _indices(name, shape[d], grid.model,
                                 grid.model_index, local.device), local)
    return _all_reduce(full, grid, "gather")


def gather_over_model(sd, grid):
    """gather_tensor over a state dict (collective: every rank of the
    group calls it with the same keys in the same order)."""
    return {k: gather_tensor(k, v, grid) for k, v in sd.items()}


def optimizer_param_names(opt, module):
    """The names in `module` of the optimizer's parameters, in the order
    of its state dict's indices."""
    names = {id(p): n for n, p in module.named_parameters()}
    return [names[id(p)] for g in opt.param_groups for p in g["params"]]


def _map_optimizer_state(opt_sd, names, fn):
    state = {}
    for i in sorted(opt_sd["state"]):
        state[i] = {k: fn(names[i], v) if torch.is_tensor(v) and v.dim()
                    else v for k, v in opt_sd["state"][i].items()}
    return {**opt_sd, "state": state}


def gather_optimizer_state(opt_sd, names, grid):
    """An optimizer state dict with the moments of split parameters
    gathered (collective over the tensor-parallel group)."""
    return _map_optimizer_state(
        opt_sd, names, lambda n, v: gather_tensor(n, v, grid))


def shard_optimizer_state(opt_sd, names, m, r):
    """A full optimizer state dict cut to rank r of m's moments."""
    return _map_optimizer_state(
        opt_sd, names, lambda n, v: shard_tensor(n, v, m, r))


def sync_replicated_grads(opt, module, grid: Grid):
    """Before each step of `opt`, average the gradients of `module`'s
    replicated parameters over the tensor-parallel group (one all-reduce
    of them all, flattened). A no-op where model is 1."""
    if grid.model == 1:
        return
    params = [p for n, p in module.named_parameters() if shard_dim(n) is None]

    def hook(optimizer, args, kwargs):
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]), grid,
                           "grads")
        flat /= grid.model
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()

    opt.register_step_pre_hook(hook)


def shard_generator(gen, grid: Grid):
    """Keep rank grid.model_index's shard of every split parameter of the
    full generator `gen`, in place, and hand the grid to the transformer's
    attention and F3N modules, whose forwards then run on the shard. A
    no-op where model is 1."""
    if grid.model == 1:
        return gen
    with torch.no_grad():
        for name, p in list(gen.named_parameters()):
            if shard_dim(name) is not None:
                owner, attr = name.rsplit(".", 1)
                setattr(gen.get_submodule(owner), attr, nn.Parameter(
                    shard_tensor(name, p.detach(), grid.model,
                                 grid.model_index).contiguous()))
    for block in gen.transformer:
        block.attn.tp = grid
        block.mlp.tp = grid
    return gen
