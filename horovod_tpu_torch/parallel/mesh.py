"""The world as process groups: the data-parallel group and named mesh axes.

Counterpart of ``horovod_tpu/parallel/mesh.py``. There a mesh is a grid of
TPU devices whose axes XLA's collectives run over; here the ranks that
``hvd.init()`` started (one per GPU) are laid out on a grid in rank order
(the last axis fastest, as a reshape of the rank list), and each named axis
gets the process group of the ranks that differ only along it. A function
that takes an axis name (``ring_attention(..., "sp")``, the model's
``sp_axis``) resolves it to this rank's group through ``axis_group``.
"""

import collections
import math

import torch.distributed as dist

from horovod_tpu_torch.common import basics

DataParallelGroup = collections.namedtuple("DataParallelGroup",
                                           ["group", "size"])

# axis name -> this rank's process group along it (the last hybrid_mesh)
_axes = {}


def data_parallel_group():
    """(process group, its size) of the data-parallel world."""
    group = basics.process_group()
    return DataParallelGroup(group, dist.get_world_size(group))


class ProcessMesh:
    """A grid of the world's ranks with named axes: ``shape[name]`` is an
    axis' size (a -1 resolved), ``groups[name]`` this rank's process group
    along it."""

    def __init__(self, shape, axis_names, groups):
        self.shape = dict(zip(axis_names, shape))
        self.groups = groups

    def size(self, name):
        return self.shape[name]

    def rank(self, name):
        """This rank's index along ``name``."""
        return dist.get_rank(self.groups[name])


def hybrid_mesh(axis_shape, axis_names):
    """N-D mesh over the world, e.g. ``hybrid_mesh((-1, 4), ("dp", "sp"))``.

    One axis may be -1 (inferred). Rank r sits at the grid coordinates of r
    in row-major order, so the trailing axis holds consecutive ranks (GPUs
    of one host, on NVLink, when the launcher numbers them so). Builds one
    process group per line of every axis (every rank must call this, with
    the same arguments) and registers this rank's group under each axis
    name for ``axis_group``. Returns a ``ProcessMesh``."""
    world = dist.get_world_size(basics.process_group())
    shape = [int(s) for s in axis_shape]
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(shape):
        raise ValueError("axis_shape %r and axis_names %r must pair up, "
                         "names distinct" % (axis_shape, axis_names))
    if shape.count(-1) > 1:
        raise ValueError("at most one axis may be -1: %r" % (axis_shape,))
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        if known <= 0 or world % known:
            raise ValueError("cannot infer -1 in mesh shape %r over %d ranks"
                             % (axis_shape, world))
        shape[shape.index(-1)] = world // known
    if math.prod(shape) != world or min(shape) <= 0:
        raise ValueError("mesh shape %r != %d ranks" % (shape, world))
    me = dist.get_rank(basics.process_group())
    groups = {}
    for axis, name in enumerate(axis_names):
        for line in _lines(shape, axis):
            if len(line) == world:
                group = basics.process_group()  # the whole world
            else:
                group = dist.new_group(ranks=line)
            if me in line:
                groups[name] = group
    _axes.clear()
    _axes.update(groups)
    return ProcessMesh(shape, axis_names, groups)


def _lines(shape, axis):
    """The rank lists along ``axis`` of a row-major grid of ``shape``, in
    the same order on every rank."""
    stride = math.prod(shape[axis + 1:])
    lines = []
    for base in range(math.prod(shape)):
        if (base // stride) % shape[axis] == 0:
            lines.append([base + i * stride for i in range(shape[axis])])
    return lines


def axis_group(axis):
    """This rank's process group along the axis named ``axis`` by the last
    ``hybrid_mesh``."""
    if axis not in _axes:
        raise ValueError("no mesh axis named %r (have %s): build one with "
                         "horovod_tpu_torch.parallel.hybrid_mesh"
                         % (axis, sorted(_axes) or "none"))
    return _axes[axis]
