"""Process groups: subgroups of the world that a collective runs over.

Counterpart of ``horovod_tpu/groups.py``. There a group is registered in
the native core's group table; here it is a ``torch.distributed`` process
group (an NCCL communicator over the members on the GPU, gloo on the
CPU), wrapped in a ``ProcessGroup`` handle that every ``group=`` of the
port accepts, and it is registered in the port's negotiation core's
table too, for the asynchronous collectives: at ``new_group`` while the
core runs, else when it starts (every group of this ``init()``, in
creation order), so that the core's id (``ProcessGroup.core_id``) is the
group's ``id``. The core's device plane forms a group of its own over the
members for the CUDA tensors of the asynchronous calls
(``common/device_plane.py``).

The rule is torch.distributed's and the reference's: EVERY rank, members
and non-members alike, calls ``new_group`` with the same rank list, in the
same order relative to its other ``new_group`` calls. Ids come from a
per-process counter that ``init()`` resets, so the same call sequence
gives the same ids on every rank.
"""

import ctypes

import torch.distributed as dist

from horovod_tpu_torch.common import basics


class ProcessGroup:
    """Handle to a process group: ``id`` (0 is the world), ``ranks`` the
    ascending member world ranks (None for the world)."""

    def __init__(self, group_id, ranks=None, torch_group=None):
        self.id = int(group_id)
        self.ranks = tuple(ranks) if ranks is not None else None
        self._torch_group = torch_group
        # the group's id in the negotiation core's table (0 for the
        # world), set when it is registered there
        self.core_id = 0 if self.id == 0 else None
        self._core_start = None

    def size(self):
        """Member count (the world size for the world group)."""
        if self.id == 0:
            return basics.size()
        return len(self.ranks)

    def rank(self):
        """This process's position among the members, or -1 when it is
        not a member (a non-member sits the group's collectives out)."""
        if self.id == 0:
            return basics.rank()
        me = basics.rank()
        return self.ranks.index(me) if me in self.ranks else -1

    def torch_group(self):
        """The ``torch.distributed`` process group behind the handle."""
        if self.id == 0:
            return basics.process_group()
        return self._torch_group

    def __contains__(self, world_rank):
        if self.id == 0:
            return True
        return int(world_rank) in self.ranks

    def __eq__(self, other):
        return isinstance(other, ProcessGroup) and other.id == self.id

    def __hash__(self):
        return hash(("ProcessGroup", self.id))

    def __repr__(self):
        if self.id == 0:
            return "ProcessGroup(WORLD)"
        return "ProcessGroup(id=%d, ranks=%r)" % (self.id, list(self.ranks))


#: The world group: ``group=WORLD`` (or ``group=None``) is the world.
WORLD = ProcessGroup(0)

_next_id = [0]
# the groups of this init(), in creation order
_created = []


def reset():
    """Restarts the id counter (``init()`` and ``shutdown()`` call it: the
    groups of one process group's life are numbered from 1)."""
    _next_id[0] = 0
    del _created[:]


def created():
    """The groups ``new_group`` formed since ``init()``, in order."""
    return list(_created)


def register_with_core(pg):
    """Registers ``pg`` in the running negotiation core's group table
    (once a start of the core; every rank in the same order, so the ids
    agree). Returns its core id."""
    from horovod_tpu_torch.common import core
    c = core.get_core()
    start = core.starts()
    if pg._core_start != start:
        members = (ctypes.c_int32 * len(pg.ranks))(*pg.ranks)
        gid = c.lib.horovod_tpu_new_group(members, len(pg.ranks))
        if gid <= 0:
            raise RuntimeError("the negotiation core refused process group "
                               "%r (code %d)" % (pg, gid))
        pg.core_id, pg._core_start = gid, start
    return pg.core_id


def core_group_id(group):
    """The negotiation core's group id behind a ``group=`` of the
    asynchronous calls: 0 for None or ``WORLD``, the registered id of a
    ``ProcessGroup``, an int as it is (an id of the core's table). A
    ``ProcessGroup`` this rank is not a member of raises ``ValueError``
    before anything is enqueued."""
    if group is None:
        return 0
    if isinstance(group, ProcessGroup):
        if group.id == 0:
            return 0
        if group.rank() < 0:
            raise ValueError("this rank is not a member of %r: a non-member "
                             "must not submit the group's collectives"
                             % (group,))
        return register_with_core(group)
    if isinstance(group, int) and not isinstance(group, bool):
        return group
    raise TypeError("group= of the asynchronous collectives takes None, "
                    "WORLD, a ProcessGroup of new_group or a core group "
                    "id, not %r" % (group,))


def new_group(ranks):
    """Creates a process group over ``ranks`` (world ranks).

    COLLECTIVE BY CONVENTION: call it on EVERY rank with the same list,
    in the same order relative to other ``new_group`` calls. Returns a
    ``ProcessGroup``; a non-member gets the same handle, with
    ``.rank() == -1``, and must not submit the group's collectives."""
    members = sorted(int(r) for r in ranks)
    if len(set(members)) != len(members):
        raise ValueError("duplicate ranks in %r" % (ranks,))
    if not basics.is_initialized():
        raise RuntimeError("hvd.init() must run before new_group()")
    world = basics.size()
    if not members or members[0] < 0 or members[-1] >= world:
        raise ValueError("invalid process group %r: ranks must be unique "
                         "world ranks in [0, %d)" % (ranks, world))
    torch_group = dist.new_group(ranks=members)
    _next_id[0] += 1
    pg = ProcessGroup(_next_id[0], members, torch_group)
    _created.append(pg)
    from horovod_tpu_torch.common import core, device_plane
    if core.is_initialized():
        register_with_core(pg)
        plane = device_plane.current()
        if plane is not None:
            plane.add_group(pg)
    return pg


def resolve_group(group):
    """The ``torch.distributed`` process group behind a ``group=``
    argument: None or WORLD -> the world, a ``ProcessGroup`` -> its
    group, a ``torch.distributed`` process group as it is."""
    if group is None:
        return basics.process_group()
    if isinstance(group, ProcessGroup):
        return group.torch_group()
    return group


def group_size(group):
    """Member count behind a ``group=`` argument (the world's for None)."""
    if group is None or isinstance(group, ProcessGroup):
        return (group or WORLD).size()
    return dist.get_world_size(group)


def group_rank(group):
    """This process's position behind a ``group=`` argument (its world
    rank for None); -1 when it is not a member."""
    if group is None or isinstance(group, ProcessGroup):
        return (group or WORLD).rank()
    return dist.get_rank(group)


def assert_sharded_update_world_scope(group=None):
    """The guard of every sharded update (``horovod_tpu/groups.py:129``):
    the sharded weight update shards its state over the WORLD, so it does
    not compose with a group-scoped reduction, an explicit non-world
    ``group=`` or an active mesh (``init(model_parallel=k)``). Called when
    the optimizer is built and again on every update, so a mesh formed
    after the optimizer fails the next step."""
    world = (group is None or group == WORLD or group is dist.group.WORLD)
    if not world or (group is None and basics.batch_group() is not None):
        raise ValueError(
            "sharded_update composes with the world group only; a "
            "group-scoped (mesh) job must use the replicated update "
            "per batch group (docs/GROUPS.md)")
