"""The (data, model) mesh of a world and the head's sharding rules.

Port of ``situation_recognition_tpu/parallel/mesh.py``.  JAX lays a
``Mesh(('data', 'model'))`` over its devices and lets ``jit`` emit the
collectives; the port runs one process per card and spells them out, so a
mesh here is this rank's place in the world and the process groups of its
two axes:

* rank r sits at data index ``r // model`` and model index ``r % model``
  (JAX's ``reshape(n // model, model)`` of the device list);
* the batch is split over ``data``: data index i takes rows ``i*B/D ...
  (i+1)*B/D`` of each global batch of B rows (``rows``);
* the two classifier kernels split their contraction dim over ``model``
  (``head_param_sharding``): model index m holds input columns ``m*d/M
  ... (m+1)*d/M`` of ``verb_classifier`` and ``nouns_classifier``, whose
  outputs (504, 2001) no axis divides; the rest is replicated.

A model group must lie on one node (JAX's ``make_distributed_mesh`` refuses
a group that spans hosts): its partial-sum all-reduce runs every step.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Sequence

import torch.distributed as dist

from situation_recognition_tpu_torch.parallel import distributed

#: the head's parameters that split their contraction dim over ``model``
#: (torch's (out, in) layout: dim 1)
SHARDED = ("verb_classifier.1.weight", "nouns_classifier.1.weight")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) world.  ``data_group`` is the
    process group of the ranks that share this rank's model index (None
    without ``torch.distributed``: no collective is issued);
    ``model_group`` that of the ranks that share its data index (None when
    ``model`` is 1)."""

    world: int
    model: int
    rank: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def data(self) -> int:
        return self.world // self.model

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def rows(self, batch: int) -> slice:
        """This rank's row block of a global batch of ``batch`` rows."""
        per = batch // self.data
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def cols(self, width: int) -> slice:
        """This rank's block of a contraction dim of ``width``, which the
        model axis must divide (``check_cols``)."""
        check_cols(width, self.model)
        per = width // self.model
        return slice(self.model_index * per, (self.model_index + 1) * per)


def check_cols(width: int, model: int) -> None:
    """Raise where ``model`` does not divide a sharded contraction dim of
    ``width``, in the words of JAX's ``device_put`` of a ``P('model',
    None)`` kernel (a remainder would leave columns out of every shard)."""
    if width % model != 0:
        raise ValueError(
            f"the sharding PartitionSpec('model', None) over model={model} "
            f"implies that the global size of its dimension 0 should be "
            f"divisible by {model}, but it is equal to {width}")


def check_model_groups(nodes: Sequence, model: int) -> None:
    """Raise where a model group (``model`` consecutive ranks) holds ranks
    of two nodes; ``nodes`` is each rank's node."""
    for d in range(len(nodes) // model):
        row = set(nodes[d * model:(d + 1) * model])
        if len(row) > 1:
            raise ValueError(
                f"model_axis={model} does not divide the ranks per node — "
                f"model group {d} would span nodes; use a model_axis that "
                f"divides the cards of each node")


def make_mesh(world: Optional[int] = None, model: int = 1,
              nodes: Optional[Sequence] = None) -> Mesh:
    """The mesh of this process's world (``init_distributed``), or of one
    process without ``torch.distributed``.  ``world``: the ranks to span,
    by default all of them; ``nodes``: each rank's node, by default found
    with one all-reduce (``distributed.node_ids``).  Every rank calls it,
    in the same order as its other collectives (``new_group``)."""
    avail = dist.get_world_size() if dist.is_initialized() else 1
    world = avail if world is None else int(world)
    if world > avail:
        # fewer ranks than asked would double each one's rows against the
        # caller's sizing with no error
        raise ValueError(f"requested {world} ranks but only {avail} are "
                         f"visible")
    if world != avail:
        raise ValueError(f"a mesh spans the whole world of {avail} ranks, "
                         f"not {world}")
    if model < 1 or world % model != 0:
        raise ValueError(f"{world} ranks not divisible by model={model}")
    if not dist.is_initialized():
        return Mesh(world=1, model=1, rank=0)
    rank = dist.get_rank()
    if model > 1:
        check_model_groups(
            distributed.node_ids(world) if nodes is None else nodes, model)
    ndata = world // model
    data_group = model_group = None
    if model == 1:
        data_group = dist.group.WORLD
    else:
        # every rank creates every group, in one order
        for m in range(model):
            g = dist.new_group([m + d * model for d in range(ndata)])
            if rank % model == m:
                data_group = g
        for d in range(ndata):
            g = dist.new_group(list(range(d * model, (d + 1) * model)))
            if rank // model == d:
                model_group = g
    return Mesh(world=world, model=model, rank=rank, data_group=data_group,
                model_group=model_group)


def head_param_sharding(mesh: Mesh, names) -> "OrderedDict[str, tuple]":
    """Each head parameter name (a state dict or names) → its spec over
    the mesh's axes in torch's layout: ``(None, "model")`` for the two
    classifier kernels (JAX's ``P('model', None)`` of the (in, out)
    kernel), ``()`` (replicated) for the rest."""
    del mesh                      # the rule is the same for every mesh
    return OrderedDict((n, (None, "model") if n in SHARDED else ())
                       for n in names)
